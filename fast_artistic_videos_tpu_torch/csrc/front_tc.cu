// Tensor-core implicit-GEMM convolution of the stylizer front for Hopper
// (sm_90a), bfloat16 storage, float32 accumulation; plain C interface.
//
// Replaces, for bfloat16 at the shapes of ops/_conv_in.py's routing rule
// `tensor_core_route`, fast_artistic_videos_tpu/ops/front_pallas.py:44
// `_kernel` (K3): the front's zero-padded conv with the previous layer's
// instance-norm affine + ReLU as its prologue and the instance-norm
// statistics of its output. Two shape families:
//   * layer 0: 9x9, stride 1, pad 4, Cin <= 8, Cout % 32 == 0 (7 -> 32 at
//     1160x2000 for a 1080p frame, no prologue);
//   * layers 1 and 2: 3x3, stride 2, pad 1, Cin % 32 == 0, Cout % 64 == 0
//     (32 -> 64 at 1160x2000 -> 580x1000, 64 -> 128 at 580x1000 ->
//     290x500).
// Float32 K3 stays on conv_in.cu's CUDA-core template.
//
// Semantics are those of the plain version (ops/_conv_in.py
// `conv_in_plain`): the prologue is eff[0] * x + eff[1] as a separate
// float32 multiply and add, rounded to bfloat16, then the ReLU; the zero
// padding comes after it; y = bf16(acc + b); the statistics are float32
// [sum; sum of squares] of the stored outputs per channel, one atomicAdd per
// channel per block into a (2, Cout) buffer that the caller zeroes.
//
// What bounds it on the H100 (each input read once, each output written
// once; 3.35 TB/s, 989 TFLOP/s bf16): layer 0 operations, 84.2 GFLOP, 0.085
// ms; layer 1 bytes, 222 MB, 0.067 ms; layer 2 bytes, 111 MB, 0.033 ms.
// Design, for those bounds:
//   * implicit GEMM: M = the output pixels of a 16-column tile (128 or 256
//     of them), N = 32, 64 or 128 output channels, K walked in k16 steps,
//     no im2col buffer. Each k16 step's A rows are 16 contiguous bf16 of the
//     input halo in shared memory, so one ldmatrix.x4 per warp fetches a
//     warp's 16 x 16 piece of A for wgmma.mma_async (A from registers, B by
//     descriptor from the weights in wgmma's 128-byte-swizzled K-major
//     layout, packed on the host by ops/_conv_in.py `pack_front_weights`);
//   * the whole weight matrix of a block's channels (per input-channel chunk)
//     sits in shared memory, loaded by cp.async in one commit group per
//     64-wide K slice, so the products of slice j start while slices j + 1
//     ... are still in flight; A alternates between two register sets, so
//     the ldmatrix of one slice overlaps the wgmmas of the one before;
//   * persistent blocks: as many as fit the card at once, each walking the
//     tiles blockIdx.x, blockIdx.x + gridDim.x, ... With one input-channel
//     chunk (every layer of the stylizer's front) the weights are loaded
//     once per block, not once per tile (layer 0's 48 KB, once per tile,
//     would be 438 MB of L2 traffic at 1080p); with more chunks they are
//     reloaded per chunk. The halo's region also stages the epilogue's tile,
//     and each thread's statistics run over all of its block's tiles. The
//     9x9 layer (65 KB of shared memory) is held to 128 registers so that
//     two blocks share an SM (ptxas spills 88 bytes for it; it still ran
//     in 0.40 ms of device time against 0.59 at one block per SM, PERF.md);
//     layers 1 and 2 run one (their 160-190 registers, and layer 2's 215 KB);
//   * layer 0 (Cin 7): each input pixel is kept as 8 channels (16 B, the
//     eighth zero). Its 14-byte pixels are not 16-byte aligned, so the halo
//     is read with 2-byte loads (no padded copy of the input on the host).
//     K is packed along the kernel row: the A row of output pixel x for
//     kernel row u is halo[y + u][x .. x + 10) x 8 channels, 80 contiguous
//     bf16 (the tenth tap has zero weights), 5 k16 steps per kernel row and
//     45 in all (567 of 720 products useful); eight neighbouring pixels are
//     128 contiguous bytes, so its ldmatrix is free of bank conflicts;
//   * layers 1 and 2 (stride 2): at tap (u, v) the 16 pixels of an output
//     row read halo columns 2x + v. The halo is stored de-interleaved by
//     column parity (the even columns, then the odd ones), so each tap reads
//     16 consecutive slots again; the 16-byte channel group is XORed with
//     the slot (with slot / 2 at 64-byte pixels), so the eight rows of every
//     ldmatrix hit eight different bank groups. Cin is walked in chunks of
//     64 (or 32) channels; a 32-channel chunk packs two taps into one
//     64-wide K slice, so the 128-byte weight layout carries over unchanged.
//     The prologue runs in place over each arrived chunk (outside the image
//     the cp.async zero fill stays: padding comes after the prologue);
//   * the epilogue stages bias + bf16 rounding through shared memory, writes
//     16-byte vectors masked at the ragged edge and sums each channel's
//     stored values and squares (shuffles, shared-memory atomics, then one
//     float32 atomicAdd per channel per block: blocks run in no order).

#include <atomic>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;               // two warpgroups
constexpr int kMaxDevices = 64;

struct FrontArgs {
  const __nv_bfloat16* x;   // (hin, win, cin)
  const __nv_bfloat16* w;   // (chunks * slices, cout, 64): pack_front_weights
  const float* b;           // (cout,) rounded to bf16
  const float* eff;         // (2, cin) or null
  __nv_bfloat16* y;         // (hout, wout, cout)
  float* stats;             // (2, cout), zeroed
  int hin, win, cin, hout, wout, cout, pad, relu;
};

// One instantiation: a KH x KW kernel at STRIDE, CP input channels per
// chunk in shared memory (8: one 16-byte group per pixel), N output
// channels and MT m64 tiles per warpgroup per block.
template <int KH, int KW, int STRIDE, int CP, int N, int MT>
struct Cfg {
  static constexpr int kGP = CP / 8;                    // 16-byte groups per pixel
  // taps per kernel row as K walks them: with one group per pixel a k16
  // step covers two taps, so an odd row gets one zero-weight tap
  static constexpr int kKWP = kGP == 1 ? KW + (KW & 1) : KW;
  static constexpr int kNQ = KH * kKWP * kGP / 2;       // k16 steps per chunk
  static constexpr int kS = (kNQ + 3) / 4;              // 64-wide K slices per chunk
  static constexpr int kM = 2 * MT * 64;                // output pixels per block
  static constexpr int kTW = 16, kTH = kM / kTW;
  static constexpr int kHR = (kTH - 1) * STRIDE + KH;   // halo rows
  static constexpr int kHC = (kTW - 1) * STRIDE + kKWP; // halo columns
  static constexpr int kE = STRIDE == 2 ? (kHC + 1) / 2 : kHC;  // even columns first
  static constexpr int kWBytes = N * 128;               // one K slice [N][64]
  static constexpr int kHaloBytes = kHR * kHC * CP * 2;
  static constexpr int kOutBytes = kM * N * 2;          // the epilogue's staged tile
  // the halo's region also stages the epilogue (the weights stay resident)
  static constexpr int kRegion = kHaloBytes > kOutBytes ? kHaloBytes : kOutBytes;
  static constexpr int kSmem = kS * kWBytes + kRegion + 1024;  // + alignment
  // two blocks per SM where the shared memory allows (the 9x9 layer): the
  // registers are then held to 128 a thread
  static constexpr int kMinBlocks = kSmem <= 100 * 1024 ? 2 : 1;

  static_assert(kGP == 1 || kGP == 4 || kGP == 8, "8, 32 or 64 channels per chunk");
  static_assert(STRIDE == 1 || STRIDE == 2, "stride 1 or 2");
  static_assert(kGP > 1 || STRIDE == 1, "8-channel pixels only at stride 1");

  // halo slot of halo column c (stride 2: the even columns, then the odd)
  static __device__ __forceinline__ int col_slot(int c) {
    return STRIDE == 2 ? ((c & 1) ? kE + (c >> 1) : (c >> 1)) : c;
  }
  // byte offset of 16-byte group g of halo slot `slot`
  static __device__ __forceinline__ uint32_t hswz(int slot, int g) {
    if constexpr (kGP == 1) {
      return (uint32_t)slot * 16;
    } else {
      return (uint32_t)(slot * CP * 2 + ((g ^ ((slot / (8 / kGP)) & (kGP - 1))) << 4));
    }
  }
};

// cp.async.wait_group with a run-time count (at most n groups pending)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    default: cp_async_wait<0>(); break;
  }
}

template <int N>
__device__ __forceinline__ void wgmma_n(float* d, const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 128) {
    wgmma_m64n128k16(d, a, desc);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16(d, a, desc);
  } else {
    static_assert(N == 32, "N is 32, 64 or 128");
    wgmma_m64n32k16(d, a, desc);
  }
}

template <int KH, int KW, int STRIDE, int CP, int N, int MT>
__global__ void __launch_bounds__(kThreads, (Cfg<KH, KW, STRIDE, CP, N, MT>::kMinBlocks))
front_tc_kernel(FrontArgs p) {
  using C = Cfg<KH, KW, STRIDE, CP, N, MT>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_stat[2][N];
  __shared__ float s_bias[N];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* s_w = smem;                                  // [kS][N][64] bf16
  uint8_t* s_halo = smem + C::kS * C::kWBytes;          // [kHR][kHC][CP] bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3;
  const int co0 = blockIdx.z * N;
  const int tiles_x = (p.wout + C::kTW - 1) / C::kTW;
  const int ntiles = tiles_x * ((p.hout + C::kTH - 1) / C::kTH);
  int oy0 = 0, ox0 = 0, iy0 = 0, ix0 = 0;               // the current tile
  const bool prologue = p.eff != nullptr || p.relu;
  const uint32_t hbase = smem_u32(s_halo);

  for (int i = tid; i < 2 * N; i += kThreads) s_stat[i / N][i % N] = 0.f;
  for (int i = tid; i < N; i += kThreads) s_bias[i] = p.b[co0 + i];

  const int nchunk = (p.cin + CP - 1) / CP;
  const int steps = nchunk * C::kS;                     // (chunk, slice), slices inner
  // with one chunk the weights are loaded once and serve every tile
  const bool resident = nchunk == 1;
  int pending = 0;                                      // cp.async groups in flight

  // the prologue of 8 channels from ci0 (channels past cin stay zero)
  auto prologue8 = [&](float (&v)[8], int ci0) {
    if (p.eff) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (ci0 + k < p.cin)
          v[k] = bf16_round(__fadd_rn(__fmul_rn(v[k], p.eff[ci0 + k]),
                                      p.eff[p.cin + ci0 + k]));
    }
    if (p.relu) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.f);
    }
  };
  // K slice s (chunk s / kS) into its place, swizzled as wgmma reads it
  auto load_w = [&](int s) {
    const uint32_t dst = smem_u32(s_w + (s % C::kS) * C::kWBytes);
    const __nv_bfloat16* src = p.w + ((int64_t)s * p.cout + co0) * 64;
#pragma unroll
    for (int i = 0; i < N * 8 / kThreads; ++i) {
      const int e = tid + i * kThreads, n = e >> 3, g = e & 7;
      cp_async16(dst + n * 128 + ((g ^ (n & 7)) << 4), src + n * 64 + g * 8, true);
    }
  };
  // the halo of chunk c by cp.async, zero-filled outside the image
  auto load_halo = [&](int c) {
    for (int e = tid; e < C::kHR * C::kHC * C::kGP; e += kThreads) {
      const int px = e / C::kGP, g = e % C::kGP;
      const int r = px / C::kHC, col = px % C::kHC;
      const int iy = iy0 + r, ix = ix0 + col;
      const bool ok = iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win;
      const __nv_bfloat16* src =
          ok ? p.x + ((int64_t)iy * p.win + ix) * p.cin + c * CP + g * 8 : p.x;
      cp_async16(hbase + C::hswz(r * C::kHC + C::col_slot(col), g), src, ok);
    }
  };
  // the halo of a narrow input (Cin <= 8): 2-byte loads, the prologue
  // applied on the way, 8 channels per pixel; zero outside the image
  auto load_halo_narrow = [&]() {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(p.x);
    for (int e = tid; e < C::kHR * C::kHC; e += kThreads) {
      const int r = e / C::kHC, col = e % C::kHC;
      const int iy = iy0 + r, ix = ix0 + col;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
      if (iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win) {
        const unsigned short* src = xs + ((int64_t)iy * p.win + ix) * p.cin;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < p.cin) v[k] = __bfloat162float(__ushort_as_bfloat16(__ldg(src + k)));
        prologue8(v, 0);
      }
      uint4 raw;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(s_halo + C::hswz(e, 0)) = raw;
    }
  };
  // the prologue in place over the arrived chunk c (the zero fill outside
  // the image stays: padding comes after the prologue)
  auto prologue_pass = [&](int c) {
    for (int e = tid; e < C::kHR * C::kHC * C::kGP; e += kThreads) {
      const int px = e / C::kGP, g = e % C::kGP;
      const int r = px / C::kHC, col = px % C::kHC;
      const int iy = iy0 + r, ix = ix0 + col;
      if (iy < 0 || iy >= p.hin || ix < 0 || ix >= p.win) continue;
      uint4* sp = reinterpret_cast<uint4*>(s_halo + C::hswz(r * C::kHC + C::col_slot(col), g));
      uint4 raw = *sp;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
      prologue8(v, c * CP + g * 8);
#pragma unroll
      for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *sp = raw;
    }
  };
  // chunk c's loads: cp.async group j holds K slice j, group 0 also the
  // halo; without the weights, one group of the halo alone
  auto issue_chunk = [&](int c, bool weights) {
    if constexpr (STRIDE == 2) load_halo(c);
    if (weights) {
#pragma unroll 1
      for (int j = 0; j < C::kS; ++j) {
        load_w(c * C::kS + j);
        cp_async_commit();
      }
    } else {
      cp_async_commit();
    }
    pending = weights ? C::kS : 1;
    if constexpr (STRIDE == 1) load_halo_narrow();     // seen after the next barrier
  };
  // shared-memory address of the ldmatrix row this lane supplies for m64
  // tile t at k16 step q: pixel (py, px) of the tile, 16-byte group e
  auto a_addr = [&](int t, int q) -> uint32_t {
    const int e = 2 * q + (lane >> 4);
    const int py = (wg * MT + t) * 4 + wi, px = lane & 15;
    if constexpr (C::kGP == 1) {
      const int u = e / C::kKWP, v = e % C::kKWP;
      return hbase + C::hswz((py * STRIDE + u) * C::kHC + px * STRIDE + v, 0);
    } else {
      const int tap = e / C::kGP, g = e % C::kGP;
      const int u = tap / KW, v = tap % KW;
      const int cs = STRIDE == 2 ? ((v & 1) ? C::kE : 0) + px + (v >> 1) : px + v;
      return hbase + C::hswz((py * STRIDE + u) * C::kHC + cs, g);
    }
  };

  float acc[MT][N / 2];
  // One K slice: A of its k16 steps into `acur`; `aprev` holds the previous
  // slice's A, read by its wgmmas until the wait at the end of this step.
  auto step = [&](int s, uint32_t (&acur)[4][MT][4], uint32_t (&aprev)[4][MT][4]) {
    const int c = s / C::kS, j = s % C::kS;
    if (j == 0 && c > 0) {      // the next chunk: every read of this one is done
      wgmma_wait<0>();
      fence_regs(&aprev[0][0][0], 16 * MT);
      __syncthreads();
      issue_chunk(c, true);
    }
    cp_async_wait_pending(pending - 1 - j > 0 ? pending - 1 - j : 0);
    // the slices written through cp.async are read by wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if constexpr (STRIDE == 2) {
      if (j == 0 && prologue) {
        prologue_pass(c);
        __syncthreads();
      }
    }
    const uint32_t wbase = smem_u32(s_w + j * C::kWBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (j * 4 + kk < C::kNQ) {
#pragma unroll
        for (int t = 0; t < MT; ++t) ldmatrix_x4(acur[kk][t], a_addr(t, j * 4 + kk));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (j * 4 + kk < C::kNQ) {
        const uint64_t desc = sw128_desc(wbase + kk * 32);   // k16 step: 32 bytes on
#pragma unroll
        for (int t = 0; t < MT; ++t) wgmma_n<N>(acc[t], acur[kk][t], desc);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();     // the previous slice is done: aprev is free
    fence_regs(&aprev[0][0][0], 16 * MT);
  };
  uint32_t a0[4][MT][4], a1[4][MT][4];
#pragma unroll
  for (int i = 0; i < 16 * MT; ++i) (&a0[0][0][0])[i] = (&a1[0][0][0])[i] = 0u;
  constexpr int G = N / 8;                     // 16-byte groups per output pixel
  constexpr int XM = G < 8 ? G - 1 : 7;
  constexpr int kRows = kThreads / G;          // output pixels per pass
  const int g = tid % G;                       // this thread's 8 output channels
  float ssum[8], ssq[8];                       // their statistics, over every tile
#pragma unroll
  for (int k = 0; k < 8; ++k) ssum[k] = ssq[k] = 0.f;
  uint8_t* s_out = s_halo;                     // the staged tile, [kM px][N] bf16

  // persistent blocks: tile blockIdx.x, then every gridDim.x-th one
  bool first = true;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    oy0 = (tile / tiles_x) * C::kTH;
    ox0 = (tile % tiles_x) * C::kTW;
    iy0 = oy0 * STRIDE - p.pad;
    ix0 = ox0 * STRIDE - p.pad;
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[t][i] = 0.f;
    issue_chunk(0, first || !resident);
    first = false;
    for (int s = 0; s < steps; s += 2) {
      step(s, a0, a1);
      if (s + 1 < steps) step(s + 1, a1, a0);
    }
    wgmma_wait<0>();
    fence_regs(&a0[0][0][0], 16 * MT);
    fence_regs(&a1[0][0][0], 16 * MT);
    fence_regs(&acc[0][0], MT * N / 2);

    // epilogue: bias, bf16 into the (read) halo region as [kM px][N] with
    // the 16-byte group XORed by the pixel, then 16-byte stores
    __syncthreads();
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int mrow = (wg * MT + t) * 64 + 16 * wi + (lane >> 2);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mrow + 8 * h;
          const int n = 8 * j + 2 * (lane & 3);
          const float v0 = acc[t][4 * j + 2 * h] + s_bias[n];
          const float v1 = acc[t][4 * j + 2 * h + 1] + s_bias[n + 1];
          *reinterpret_cast<__nv_bfloat162*>(
              s_out + m * (N * 2) + ((j ^ (m & XM)) << 4) + 4 * (lane & 3)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < C::kM / kRows; ++i) {
      const int m = tid / G + kRows * i;
      const int oy = oy0 + m / C::kTW, ox = ox0 + m % C::kTW;
      if (oy >= p.hout || ox >= p.wout) continue;
      const uint4 val =
          *reinterpret_cast<const uint4*>(s_out + m * (N * 2) + ((g ^ (m & XM)) << 4));
      *reinterpret_cast<uint4*>(p.y + ((int64_t)oy * p.wout + ox) * p.cout + co0 + g * 8) = val;
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
    __syncthreads();     // the staged tile is read: the next halo may land there
  }

  // lanes lane, lane ^ G, lane ^ 2G, ... hold the same channels
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ssum[k] += __shfl_xor_sync(0xffffffffu, ssum[k], off);
      ssq[k] += __shfl_xor_sync(0xffffffffu, ssq[k], off);
    }
  }
  if (lane < G) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      atomicAdd(&s_stat[0][g * 8 + k], ssum[k]);
      atomicAdd(&s_stat[1][g * 8 + k], ssq[k]);
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * N; i += kThreads)
    atomicAdd(&p.stats[(i / N) * p.cout + co0 + i % N], s_stat[i / N][i % N]);
}

// Blocks of the instantiation that fit the device at once (SMs x blocks per
// SM), after lifting its dynamic shared-memory limit; once per device.
template <int KH, int KW, int STRIDE, int CP, int N, int MT>
cudaError_t resident_blocks(int* out) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = cache[dev].load();
  if (n == 0) {
    auto kern = front_tc_kernel<KH, KW, STRIDE, CP, N, MT>;
    const int smem = Cfg<KH, KW, STRIDE, CP, N, MT>::kSmem;
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    n = sms * per_sm;
    cache[dev].store(n);
  }
  *out = n;
  return cudaSuccess;
}

template <int KH, int KW, int STRIDE, int CP, int N, int MT>
int launch(const FrontArgs& p, cudaStream_t stream) {
  using C = Cfg<KH, KW, STRIDE, CP, N, MT>;
  int blocks = 0;
  cudaError_t e = resident_blocks<KH, KW, STRIDE, CP, N, MT>(&blocks);
  if (e != cudaSuccess) return (int)e;
  const int zblocks = p.cout / N;
  const long long ntiles = (long long)((p.wout + C::kTW - 1) / C::kTW)
                           * ((p.hout + C::kTH - 1) / C::kTH);
  const long long per_z = blocks / zblocks > 1 ? blocks / zblocks : 1;
  dim3 grid((unsigned)(ntiles < per_z ? ntiles : per_z), 1, zblocks);
  front_tc_kernel<KH, KW, STRIDE, CP, N, MT><<<grid, kThreads, C::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The front conv of one bf16 NHWC image (hin, win, cin) -> (hout, wout,
// cout), hout = (hin + 2 pad - kh) / stride + 1, on the current device and
// `stream`. w is packed by ops/_conv_in.py `pack_front_weights` (64-channel
// chunks when cin % 64 == 0, else 32; 8 for the 9x9 layer); eff may be
// null; stats is a zeroed (2, cout) float32 buffer. Shapes: kh 9, stride 1,
// cin <= 8, cout % 32 == 0; or kh 3, stride 2, cin % 32 == 0, cout % 64 ==
// 0. x (at cin % 32 == 0) and y 16-byte aligned.
extern "C" int fav_front_tc(const void* x, const void* w, const void* b, const void* eff,
                            void* y, void* stats, int hin, int win, int cin, int cout,
                            int kh, int stride, int pad, int relu, void* stream) {
  if (!stats || cin < 1 || cout < 1 || pad < 0 || kh < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  FrontArgs p;
  p.x = (const __nv_bfloat16*)x; p.w = (const __nv_bfloat16*)w; p.b = (const float*)b;
  p.eff = (const float*)eff; p.y = (__nv_bfloat16*)y; p.stats = (float*)stats;
  p.hin = hin; p.win = win; p.cin = cin; p.cout = cout; p.pad = pad; p.relu = relu;
  p.hout = (hin + 2 * pad - kh) / stride + 1;
  p.wout = (win + 2 * pad - kh) / stride + 1;
  if (hin + 2 * pad < kh || win + 2 * pad < kh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kh == 9 && stride == 1 && cin <= 8 && cout % 32 == 0)
    return launch<9, 9, 1, 8, 32, 2>(p, s);
  if (kh == 3 && stride == 2 && cin % 32 == 0 && cout % 64 == 0) {
    const bool c64 = cin % 64 == 0, n128 = cout % 128 == 0;
    if (c64 && n128) return launch<3, 3, 2, 64, 128, 1>(p, s);
    if (c64) return launch<3, 3, 2, 64, 64, 2>(p, s);
    if (n128) return launch<3, 3, 2, 32, 128, 1>(p, s);
    return launch<3, 3, 2, 32, 64, 2>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
