// Register-tiled float32 convolution of the stylizer front for Hopper
// (sm_90a) on the CUDA cores; plain C interface.
//
// Replaces, in float32 at the shapes of ops/_conv_in.py's routing rule
// `conv_route`, fast_artistic_videos_tpu/ops/front_pallas.py:44 `_kernel`
// (K3): the front's zero-padded conv with the previous layer's
// instance-norm affine + ReLU as its prologue, bias, and the instance-norm
// statistics of its output. Two shape families:
//   * 9x9, stride 1, pad 4, Cin <= 8, Cout % 32 == 0 (layer 0: 7 -> 32 at
//     1160x2000 for a 1080p frame, no prologue);
//   * 3x3, stride 2, pad 1, Cin % 8 == 0, Cout % 64 == 0 (layers 1 and 2:
//     32 -> 64 at 1160x2000 -> 580x1000, 64 -> 128 at 580x1000 -> 290x500,
//     with the prologue).
// Bfloat16 K3 runs on the tensor cores (front_tc.cu); other float32 shapes
// stay on conv_in.cu.
//
// Semantics are those of conv_in.cu: the prologue eff[0] * x + eff[1] is a
// separate float32 multiply and add (__fmul_rn / __fadd_rn), then the
// ReLU; zero padding comes after the prologue (a tap outside the image
// reads 0, not eff(0)); y = acc + b; the statistics are float32 [sum; sum
// of squares] of the stored outputs per channel, added with atomics into a
// (2, Cout) buffer that the caller zeroes.
//
// What bounds it on the H100: operations. Float32 runs with TF32 off, so
// the rate is the CUDA cores' 67 TFLOP/s of FMAs: at 1080p layer 0 is 84.2
// GFLOP (1.257 ms), layers 1 and 2 21.4 GFLOP each (0.319 ms); their bytes
// take a fifth of that or less. So the design keeps the FMA pipes fed, as
// conv3x3_f32.cu does for K2 and K4:
//   * the taps, the stride and the channels per block are compile-time
//     constants and every tap loop is unrolled;
//   * 256 threads, each with an 8-pixel (eight neighbouring columns of one
//     row) x 8-channel register tile; its channels are 4cg..4cg+3 and
//     N/2+4cg..N/2+4cg+3 of the block's N, so a warp's weight loads are
//     contiguous;
//   * the input halo sits in shared memory channel-major, copied by 4-byte
//     cp.async (zero-filled outside the image and past Cin) in chunks of 8
//     input channels; each thread puts the elements it copied through the
//     prologue, so the pass needs no barrier of its own and each input
//     element goes through it once per block;
//   * 3x3 stride 2: a block owns 8 x 16 output pixels x 128 channels (Cout
//     % 128 == 0, layer 2) or 16 x 16 x 64 (layer 1), so at the stylizer's
//     widths every input element is loaded once per block. The halo (17 or
//     33 rows x 33 columns per channel) is stored by column parity, the even
//     columns then the odd ones: for one (channel, kernel row) a thread's
//     eight outputs read 9 even and 8 odd contiguous values (five vector
//     loads) for all three taps, 192 FMAs for 11 loads. Chunks of halo and
//     weights ([c][tap][N]) are double-buffered (2 x 55 KB, two blocks per
//     SM);
//   * 9x9 stride 1: Cin is padded to 8 with zero weights and the halo (24 x
//     40 per channel, 30 KB) is loaded once; the weights stream by kernel
//     row ([tap][c][32], 9 KB a row, double-buffered) so that two blocks
//     fit on an SM. A block owns 16 x 32 pixels x 32 channels; per (channel,
//     kernel row) a thread loads its 16 halo values once and slides them
//     over the nine taps: 576 FMAs for 22 loads;
//   * at most 128 registers a thread (two blocks per SM);
//   * the weights are packed once per tensor version by the wrapper
//     (ops/_conv_in.py `pack_front_f32_weights`): 9x9 as (9, 9, 8, Cout),
//     3x3 as (Cin, 3, 3, Cout);
//   * the epilogue stores two 16-byte vectors per pixel; each thread sums
//     its 8 channels' stored values and squares, shuffles and shared-memory
//     atomics reduce them, and one float32 atomicAdd per channel per block
//     reaches the statistics buffer (blocks run in no order).

#include <atomic>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPX = 8;                      // pixels per thread (one row)
constexpr int kCO = 8;                      // output channels per thread
constexpr int kCC = 8;                      // input channels per chunk
constexpr int kMaxDevices = 64;

struct FrontF32Args {
  const float* x;      // (hin, win, cin)
  const float* w;      // 9x9: (9, 9, 8, cout); 3x3: (cin, 3, 3, cout)
  const float* b;      // (cout,)
  const float* eff;    // (2, cin) or null
  float* y;            // (hout, wout, cout)
  float* stats;        // (2, cout) zeroed, or null
  int hin, win, cin, hout, wout, cout, pad, relu;
};

// One block's geometry: a TH x TW output tile of a KH x KH conv at STRIDE,
// N output channels.
template <int KH, int STRIDE, int TH, int TW, int N>
struct Geo {
  static constexpr int kHR = (TH - 1) * STRIDE + KH;    // halo rows
  static constexpr int kHC = (TW - 1) * STRIDE + KH;    // halo columns
  // stride 2: even columns at slots 0.., odd columns from slot kOdd
  static constexpr int kOdd = STRIDE == 2 ? ((kHC + 1) / 2 + 3) & ~3 : 0;
  static constexpr int kRow = STRIDE == 2 ? kOdd + ((kHC / 2 + 3) & ~3) : (kHC + 3) & ~3;
  static constexpr int kHalo = kCC * kHR * kRow;        // floats of one halo chunk
  static constexpr int kCG = N / 8;                     // channel groups
  static constexpr int kPG = kThreads / kCG;            // pixel groups
  static_assert(kPG * kPX == TH * TW, "thread tile mapping");
  static_assert(kHC > 32 && TW % kPX == 0, "the copy loop steps 32 halo pixels");

  static __device__ __forceinline__ int slot(int hq) {
    return STRIDE == 2 ? ((hq & 1) ? kOdd + (hq >> 1) : (hq >> 1)) : hq;
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Copy input channels c0..c0+7 of the block's halo (rows from iy0, columns
// from ix0) into s_in, or, with PASS, put the elements this thread copied
// through the prologue in place. Thread t handles channel t & 7 of the halo
// pixels t >> 3, (t >> 3) + 32, ... (the same elements in both passes).
template <class G, bool PASS>
__device__ __forceinline__ void halo_chunk(const FrontF32Args& p, float* s_in, int c0, int iy0,
                                           int ix0) {
  const int c = threadIdx.x & (kCC - 1), ci = c0 + c;
  const bool chan_ok = ci < p.cin;
  float scale = 1.f, shift = 0.f;
  if (PASS && p.eff && chan_ok) {
    scale = p.eff[ci];
    shift = p.eff[p.cin + ci];
  }
  int hr = 0, hq = threadIdx.x >> 3;
  while (hr < G::kHR) {
    const int iy = iy0 + hr, ix = ix0 + hq;
    const bool ok = chan_ok && iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win;
    float* dst = s_in + (c * G::kHR + hr) * G::kRow + G::slot(hq);
    if (PASS) {
      if (ok) {
        float v = *dst;
        if (p.eff) v = __fadd_rn(__fmul_rn(v, scale), shift);
        if (p.relu) v = fmaxf(v, 0.f);
        *dst = v;
      }
    } else {
      cp_async4(smem_u32(dst), ok ? p.x + ((int64_t)iy * p.win + ix) * p.cin + ci : p.x, ok);
    }
    hq += 32;
    if (hq >= G::kHC) {
      hq -= G::kHC;
      ++hr;
    }
  }
}

// Epilogue: bias, two 16-byte stores per pixel, and the statistics of the
// stored values (shuffles over the lanes that hold the same channels,
// shared-memory atomics, one global atomicAdd per channel per block).
template <class G, int N>
__device__ __forceinline__ void epilogue(const FrontF32Args& p, float (&acc)[kPX][kCO],
                                         float (*s_stat)[N], int oy, int ox, int co0, int cg) {
  float bias[kCO], ssum[kCO], ssq[kCO];
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    bias[j] = p.b[co0 + (j >> 2) * (N / 2) + 4 * cg + (j & 3)];
    ssum[j] = ssq[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    if (oy >= p.hout || ox + i >= p.wout) continue;
    float v[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      v[j] = acc[i][j] + bias[j];
      ssum[j] += v[j];
      ssq[j] += v[j] * v[j];
    }
    float* yp = p.y + ((int64_t)oy * p.wout + ox + i) * p.cout + co0 + 4 * cg;
    *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(yp + N / 2) = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (!p.stats) return;               // uniform across the block
#pragma unroll
  for (int j = 0; j < kCO; ++j) {     // lanes l, l ^ kCG, ... hold the same channels
#pragma unroll
    for (int m = G::kCG; m < 32; m <<= 1) {
      ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], m);
      ssq[j] += __shfl_xor_sync(0xffffffffu, ssq[j], m);
    }
  }
  if ((threadIdx.x & 31) < G::kCG) {  // s_stat's zeroing was seen at the loop's barriers
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int co = (j >> 2) * (N / 2) + 4 * cg + (j & 3);
      atomicAdd(&s_stat[0][co], ssum[j]);
      atomicAdd(&s_stat[1][co], ssq[j]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * N; e += kThreads)
    atomicAdd(&p.stats[(e / N) * p.cout + co0 + e % N], s_stat[e / N][e % N]);
}

// ---- 3x3, stride 2, pad 1: layers 1 and 2 --------------------------------

template <int TH, int N>
struct S2 {
  using G = Geo<3, 2, TH, 16, N>;
  static constexpr int kWF = kCC * 9 * N;               // weight floats per chunk
  static constexpr int kStage = G::kHalo + kWF;
  static constexpr int kSmem = 2 * kStage * (int)sizeof(float);
};

template <int TH, int N>
__global__ void __launch_bounds__(kThreads, 2) front_f32_s2_kernel(FrontF32Args p) {
  using C = S2<TH, N>;
  using G = typename C::G;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_stat[2][N];

  const int tid = threadIdx.x;
  const int cg = tid % G::kCG, pg = tid / G::kCG;
  const int pr = pg / (16 / kPX), pc = (pg % (16 / kPX)) * kPX;
  const int co0 = blockIdx.z * N;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * 16;
  const int iy0 = oy0 * 2 - p.pad, ix0 = ox0 * 2 - p.pad;
  const bool prologue = p.eff != nullptr || p.relu;
  for (int e = tid; e < 2 * N; e += kThreads) s_stat[e / N][e % N] = 0.f;

  auto load = [&](int k, int s) {
    float* s_in = smem + s * C::kStage;
    halo_chunk<G, false>(p, s_in, k * kCC, iy0, ix0);
    const float* wsrc = p.w + (int64_t)k * kCC * 9 * p.cout + co0;
    float* s_w = s_in + G::kHalo;
    for (int e = tid; e < C::kWF / 4; e += kThreads) {
      const int row = e / (N / 4), q = e % (N / 4);     // row = c * 9 + tap
      cp_async16(smem_u32(s_w + row * N + q * 4), wsrc + (int64_t)row * p.cout + q * 4, true);
    }
  };

  float acc[kPX][kCO];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.f;

  const int nchunk = p.cin / kCC;
  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    const int s = k & 1;
    cp_async_wait<0>();          // chunk k has landed (this thread's copies)
    if (prologue) halo_chunk<G, true>(p, smem + s * C::kStage, k * kCC, iy0, ix0);
    __syncthreads();             // every copy and pass of chunk k is done; every
                                 // thread is done with chunk k - 1, in stage s ^ 1
    if (k + 1 < nchunk) {
      load(k + 1, s ^ 1);
      cp_async_commit();
    }
    const float* sx = smem + s * C::kStage + 2 * pr * G::kRow + pc;
    const float* sw = smem + s * C::kStage + G::kHalo + 4 * cg;
#pragma unroll 2
    for (int c = 0; c < kCC; ++c) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float* xr = sx + (c * G::kHR + u) * G::kRow;
        const float4 e0 = *reinterpret_cast<const float4*>(xr);
        const float4 e1 = *reinterpret_cast<const float4*>(xr + 4);
        const float e2 = xr[8];
        const float4 o0 = *reinterpret_cast<const float4*>(xr + G::kOdd);
        const float4 o1 = *reinterpret_cast<const float4*>(xr + G::kOdd + 4);
        const float ev[kPX + 1] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w, e2};
        const float od[kPX] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float* wr = sw + (c * 9 + u * 3 + v) * N;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + N / 2);
          const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            // output column pc + i reads input column 2 (pc + i) + v
            const float xv = v == 0 ? ev[i] : v == 1 ? od[i] : ev[i + 1];
#pragma unroll
            for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
  }
  epilogue<G, N>(p, acc, s_stat, oy0 + pr, ox0 + pc, co0, cg);
}

// ---- 9x9, stride 1, pad 4: layer 0 ---------------------------------------

struct K9 {
  static constexpr int N = 32;
  using G = Geo<9, 1, 16, 32, N>;
  static constexpr int kWRow = 9 * kCC * N;             // one kernel row: [tap][c][N]
  static constexpr int kSmem = (G::kHalo + 2 * kWRow) * (int)sizeof(float);
};

__global__ void __launch_bounds__(kThreads, 2) front_f32_k9_kernel(FrontF32Args p) {
  using G = K9::G;
  constexpr int N = K9::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_stat[2][N];

  const int tid = threadIdx.x;
  const int cg = tid % G::kCG, pg = tid / G::kCG;
  const int pr = pg / (32 / kPX), pc = (pg % (32 / kPX)) * kPX;
  const int co0 = blockIdx.z * N;
  const int oy0 = blockIdx.y * 16, ox0 = blockIdx.x * 32;
  const int iy0 = oy0 - p.pad, ix0 = ox0 - p.pad;
  const bool prologue = p.eff != nullptr || p.relu;
  for (int e = tid; e < 2 * N; e += kThreads) s_stat[e / N][e % N] = 0.f;
  float* s_in = smem;
  float* s_wb = smem + G::kHalo;

  // kernel row u's weights ([tap][c][N] of the block's channels) into buffer b
  auto load_row = [&](int u, int b) {
    const float* wsrc = p.w + (int64_t)u * 9 * kCC * p.cout + co0;
    float* s_w = s_wb + b * K9::kWRow;
    for (int e = tid; e < K9::kWRow / 4; e += kThreads) {
      const int row = e / (N / 4), q = e % (N / 4);     // row = tap * 8 + c
      cp_async16(smem_u32(s_w + row * N + q * 4), wsrc + (int64_t)row * p.cout + q * 4, true);
    }
  };

  float acc[kPX][kCO];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.f;

  halo_chunk<G, false>(p, s_in, 0, iy0, ix0);
  load_row(0, 0);
  cp_async_commit();
  for (int u = 0; u < 9; ++u) {
    if (u + 1 < 9) {
      load_row(u + 1, (u + 1) & 1);   // its buffer was last read in row u - 1
      cp_async_commit();
      cp_async_wait<1>();             // the halo and row u have landed
    } else {
      cp_async_wait<0>();
    }
    if (u == 0 && prologue) halo_chunk<G, true>(p, s_in, 0, iy0, ix0);
    __syncthreads();
    const float* sx = s_in + (pr + u) * G::kRow + pc;
    const float* sw = s_wb + (u & 1) * K9::kWRow + 4 * cg;
#pragma unroll 2
    for (int c = 0; c < kCC; ++c) {
      const float* xr = sx + c * G::kHR * G::kRow;
      float xv[kPX + 8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(xr + 4 * q);
        xv[4 * q] = t.x; xv[4 * q + 1] = t.y; xv[4 * q + 2] = t.z; xv[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < 9; ++v) {
        const float* wr = sw + (v * kCC + c) * N;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + N / 2);
        const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kPX; ++i)
#pragma unroll
          for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv[i + v], wv[j], acc[i][j]);
      }
    }
    __syncthreads();                  // every thread is done with buffer u & 1
  }
  epilogue<G, N>(p, acc, s_stat, oy0 + pr, ox0 + pc, co0, cg);
}

// Lift an instantiation's dynamic shared-memory limit and ask for the whole
// carveout (two blocks per SM), once per device.
template <int ID>
cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

template <int ID, int TH, int N>
int launch_s2(const FrontF32Args& p, cudaStream_t s) {
  const void* fn = (const void*)front_f32_s2_kernel<TH, N>;
  cudaError_t e = allow_smem<ID>(fn, S2<TH, N>::kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.wout + 15) / 16, (p.hout + TH - 1) / TH, p.cout / N);
  front_f32_s2_kernel<TH, N><<<grid, kThreads, S2<TH, N>::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 front conv of one NHWC image (hin, win, cin) -> (hout, wout,
// cout) on the current device and `stream`: 9x9 stride 1 pad 4 at cin <= 8,
// cout % 32 == 0, or 3x3 stride 2 pad 1 at cin % 8 == 0, cout % 64 == 0.
// w packed by ops/_conv_in.py `pack_front_f32_weights`; w and y 16-byte
// aligned; eff (2, cin) or null; stats (2, cout) zeroed.
extern "C" int fav_front_f32(const void* x, const void* w, const void* b, const void* eff,
                             void* y, void* stats, int hin, int win, int cin, int cout,
                             int kh, int stride, int pad, int relu, void* stream) {
  FrontF32Args p;
  p.x = (const float*)x; p.w = (const float*)w; p.b = (const float*)b;
  p.eff = (const float*)eff; p.y = (float*)y; p.stats = (float*)stats;
  p.hin = hin; p.win = win; p.cin = cin; p.cout = cout; p.pad = pad; p.relu = relu;
  if (hin < 1 || win < 1 || cin < 1 || cout < 1 || stride < 1) return (int)cudaErrorInvalidValue;
  p.hout = (hin + 2 * pad - kh) / stride + 1;
  p.wout = (win + 2 * pad - kh) / stride + 1;
  if (p.hout < 1 || p.wout < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kh == 9 && stride == 1 && pad == 4 && cin <= kCC && cout % K9::N == 0) {
    if (cout / K9::N > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaError_t e = allow_smem<0>((const void*)front_f32_k9_kernel, K9::kSmem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((p.wout + 31) / 32, (p.hout + 15) / 16, cout / K9::N);
    front_f32_k9_kernel<<<grid, kThreads, K9::kSmem, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (kh == 3 && stride == 2 && pad == 1 && cin % kCC == 0 && cout % 64 == 0)
    return cout % 128 == 0 ? launch_s2<1, 8, 128>(p, s) : launch_s2<2, 16, 64>(p, s);
  return (int)cudaErrorInvalidValue;
}
