// A nearest 2x upsample folded into the stride-1 zero-padded conv after it,
// float32 on the CUDA cores of Hopper (sm_90a); plain C interface.
//
// Replaces no Pallas kernel (K6): it was added for the stylizer's tail, the
// canonical net's U2 -> c3s1-64 -> U2 -> c9s1-3 (layers 8-11), which the port
// ran as an upsample written out in full, an instance norm over it and a
// cuDNN conv. It computes, in one launch, what the JAX package's
// fast_artistic_videos_tpu/models/stylizer.py `_folded_upsample_conv`
// computes with XLA convs:
//   a = relu(eff[n][0] * x + eff[n][1])          (prologue, low resolution)
//   y[2i + p, 2j + q] = b + sum_{u,v} w[u][v] a[(2i + p + u - P) / 2,
//                                               (2j + q + v - P) / 2]
// with floor division and zero padding P = (K - 1) / 2, which is zero
// padding of `a` at low resolution. Each of the four output phases (p, q)
// is a T x T conv over `a` whose weights are the sums of the taps that read
// the same low-resolution pixel (ops/upconv_kernel.py `fold_weights`): the
// 9x9 conv becomes 5x5 a phase, the 3x3 conv 2x2, inside a window of S x S
// low-resolution pixels (5 and 3) that the four phases share. The
// upsampled tensor never exists; each phase is stored straight to its place
// in the full-resolution NHWC output.
//
// Semantics are those of the port's other float32 convs (front_f32.cu): the
// prologue is a separate float32 multiply and add (__fmul_rn / __fadd_rn),
// then the ReLU, and a tap outside the image reads 0, not eff(0); y = acc +
// b, then, for the net's last layer, tanh(y) * tanh_scale; the statistics
// are float32 [sum; sum of squares] of the stored values per sample and
// channel, added with atomics into an (n, 2, cout) buffer that the caller
// zeroes.
//
// What bounds it on the H100: operations. Float32 runs with TF32 off, so
// the rate is the CUDA cores' 67 TFLOP/s of FMAs. At 1080p the folded 9x9
// 64 -> 3 layer is 19.9 GFLOP (0.30 ms) and the folded 3x3 128 -> 64 layer
// 34.0 GFLOP (0.51 ms), against 64.5 and 76.4 GFLOP unfolded; their bytes
// (the low-resolution input once, the output once) take a tenth of that.
// So the design keeps the FMA pipes fed:
//   * the kernel size, the taps each phase uses, the channels per block and
//     the thread tile are compile-time constants and every tap loop is
//     unrolled: the taps a phase does not use cost nothing;
//   * a thread owns PX neighbouring low-resolution pixels of one row x all
//     four phases x CO output channels, so one load of a halo value feeds
//     every phase and tap that reads it;
//   * 9x9 64 -> 3 (cuDNN's weak case: 3 output channels) folds to 12
//     outputs a pixel: a thread holds 4 pixels x 12 outputs, a block 8 x 128
//     pixels; per (channel, window row) it loads 8 halo values (two vectors)
//     and, per window column, the 12 weights of the four phases (three
//     broadcast vectors): 240 FMAs for 17 loads;
//   * 3x3 128 -> 64: a thread holds 4 pixels x 4 channels x 4 phases, a
//     block 8 x 16 pixels x 32 channels; per input channel 256 FMAs for 22
//     vector loads;
//   * the halo sits in shared memory channel-major, copied by 4-byte
//     cp.async (zero-filled outside the image) in chunks of CC input
//     channels; each thread puts the elements it copied through the
//     prologue, so each input element goes through it once per block;
//     chunks of halo and weights ([c][tap-phase][channel]) are
//     double-buffered (60 and 45 KB), two blocks an SM, at most 128
//     registers a thread;
//   * the folded weights are built and packed once per parameter tensor by
//     the wrapper (ops/upconv_kernel.py `pack_upconv_weights`): (cin, Q,
//     cout), Q the (window row, window column, phase row, phase column)
//     combinations a phase uses, in that order;
//   * the epilogue stores each phase's values at their full-resolution
//     place (a 3-channel thread's 8 output pixels of a row are 96
//     contiguous bytes); the statistics go through shuffles, shared-memory
//     atomics and one global atomicAdd per channel per block.

#include <atomic>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct UpconvArgs {
  const float* x;      // (n, hin, win, cin), low resolution
  const float* w;      // packed folded weights (cin, Q, cout)
  const float* b;      // (cout,)
  const float* eff;    // (n, 2, cin) or null
  float* y;            // (n, 2 hin, 2 win, cout)
  float* stats;        // (n, 2, cout) zeroed, or null
  int hin, win, cin, cout, relu;
  int apply_tanh;      // nonzero: y = tanh(acc + b) * tanh_scale
  float tanh_scale;
};

// The fold of a K x K conv (zero pad (K - 1) / 2) after a 2x upsample.
template <int K>
struct Fold {
  static constexpr int P = (K - 1) / 2;
  // floor(a / 2)
  static constexpr __host__ __device__ int fdiv(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }
  static constexpr int kMin = fdiv(-P);                        // first low-res offset
  static constexpr int kS = fdiv(K - P) - kMin + 1;            // window span
  static constexpr int kT = fdiv(K - 1 - P) - kMin + 1;        // taps a phase, each axis
  // first window index that phase ph (0 or 1) of an axis reads
  static constexpr __host__ __device__ int lo(int ph) { return fdiv(ph - P) - kMin; }
  static constexpr __host__ __device__ bool used(int d, int ph) {
    return d >= lo(ph) && d < lo(ph) + kT;
  }
  static_assert(fdiv(K - P) - fdiv(1 - P) + 1 == kT, "both phases take kT taps");
  static constexpr __host__ __device__ int count() {
    int n = 0;
    for (int du = 0; du < kS; ++du)
      for (int dv = 0; dv < kS; ++dv)
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b) n += used(du, a) && used(dv, b);
    return n;
  }
  static constexpr int kQ = count();                           // tap-phase combinations
};

// One instance: a K x K fold; a thread owns PX pixels x 4 phases x CO
// channels, NCG channel groups a block (CO * NCG channels), a TH x TW
// low-resolution pixel tile, CC input channels a chunk.
template <int K, int PX, int CO, int NCG, int TH, int TW, int CC>
struct Cfg {
  using F = Fold<K>;
  static constexpr int kPX = PX, kCO = CO, kNCG = NCG, kTH = TH, kTW = TW, kCC = CC;
  static constexpr int kCOB = CO * NCG;                        // channels a block
  static constexpr int kHR = TH + F::kS - 1;                   // halo rows
  static constexpr int kHC = TW + F::kS - 1;                   // halo columns
  static constexpr int kXV = (PX + F::kS - 1 + 3) & ~3;        // halo values a row load, whole vectors
  static constexpr int kRow = (TW - PX + kXV + 3) & ~3;        // halo row stride
  static constexpr int kHalo = CC * kHR * kRow;
  static constexpr int kWF = CC * F::kQ * kCOB;                // weight floats a chunk
  static constexpr int kStage = kHalo + kWF;
  static constexpr int kSmem = 2 * kStage * (int)sizeof(float);
  // all of a block's channels are the whole output (copied as one run)
  static constexpr bool kWhole = kCOB % 4 != 0;
  // every window tap feeds all four phases and the block holds every
  // channel: a tap's 4 x CO weights are contiguous and 16-byte aligned
  static constexpr bool kAll4 = F::kT == F::kS && NCG == 1 && (F::kQ * kCOB) % 4 == 0;
  static_assert((kThreads / NCG) * PX == TH * TW && TW % PX == 0 && PX % 4 == 0,
                "thread tile mapping");
  static_assert(32 % NCG == 0, "a warp holds whole channel groups");
  static_assert(kRow >= kHC && kHalo % 4 == 0 && kStage % 4 == 0, "16-byte stage layout");
  static_assert(kWhole ? kWF % 4 == 0 : kCOB % 4 == 0, "16-byte weight copies");
};

using K9Cfg = Cfg<9, 4, 3, 1, 8, 128, 4>;     // 9x9 -> 3 channels (layer 11)
using K3Cfg = Cfg<3, 4, 4, 8, 8, 16, 8>;      // 3x3 -> 32 a block (layer 9)

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Copy input channels c0..c0+CC-1 of the block's halo (rows from iy0,
// columns from ix0) into s_in, or, with PASS, put the elements this thread
// copied through the prologue in place. Thread t handles channel t % CC of
// halo pixels t / CC, t / CC + 256 / CC, ... (the same elements in both
// passes).
template <class C, bool PASS>
__device__ __forceinline__ void halo_chunk(const UpconvArgs& p, const float* xn,
                                           const float* effn, float* s_in, int c0, int iy0,
                                           int ix0) {
  constexpr int kStep = kThreads / C::kCC;
  const int c = threadIdx.x % C::kCC, ci = c0 + c;
  float scale = 1.f, shift = 0.f;
  if (PASS && effn) {
    scale = effn[ci];
    shift = effn[p.cin + ci];
  }
  for (int e = threadIdx.x / C::kCC; e < C::kHR * C::kHC; e += kStep) {
    const int hr = e / C::kHC, hq = e % C::kHC;
    const int iy = iy0 + hr, ix = ix0 + hq;
    const bool ok = iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win;
    float* dst = s_in + (c * C::kHR + hr) * C::kRow + hq;
    if (PASS) {
      if (ok) {
        float v = *dst;
        if (effn) v = __fadd_rn(__fmul_rn(v, scale), shift);
        if (p.relu) v = fmaxf(v, 0.f);
        *dst = v;
      }
    } else {
      cp_async4(smem_u32(dst), ok ? xn + ((int64_t)iy * p.win + ix) * p.cin + ci : xn, ok);
    }
  }
}

// The CO weights of channel group cg for tap-phase combination q of input
// channel c, from a chunk's [c][q][kCOB] weights.
template <class C>
__device__ __forceinline__ void load_w(const float* s_w, int c, int q, int cg,
                                       float (&wv)[C::kCO]) {
  const float* src = s_w + (c * C::F::kQ + q) * C::kCOB + cg * C::kCO;
  if constexpr (C::kCO % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C::kCO; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + j);
      wv[j] = t.x; wv[j + 1] = t.y; wv[j + 2] = t.z; wv[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::kCO; ++j) wv[j] = src[j];
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 2) upconv_f32_kernel(UpconvArgs p) {
  using F = typename C::F;
  constexpr int PX = C::kPX, CO = C::kCO, NCG = C::kNCG, S = F::kS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_stat[2][C::kCOB];

  const int tid = threadIdx.x;
  const int cg = tid % NCG, pg = tid / NCG;
  const int pr = pg / (C::kTW / PX), pc = (pg % (C::kTW / PX)) * PX;
  const int nblk = p.cout / C::kCOB;
  const int n = blockIdx.z / nblk, co0 = (blockIdx.z % nblk) * C::kCOB;
  const int y0 = blockIdx.y * C::kTH, x0 = blockIdx.x * C::kTW;
  const int iy0 = y0 + F::kMin, ix0 = x0 + F::kMin;
  const float* xn = p.x + (int64_t)n * p.hin * p.win * p.cin;
  const float* effn = p.eff ? p.eff + (int64_t)n * 2 * p.cin : nullptr;
  const bool prologue = effn != nullptr || p.relu;
  for (int e = tid; e < 2 * C::kCOB; e += kThreads) s_stat[e / C::kCOB][e % C::kCOB] = 0.f;

  auto load = [&](int k, int s) {
    float* s_in = smem + s * C::kStage;
    halo_chunk<C, false>(p, xn, effn, s_in, k * C::kCC, iy0, ix0);
    float* s_w = s_in + C::kHalo;
    const float* wsrc = p.w + (int64_t)k * C::kCC * F::kQ * p.cout;
    if constexpr (C::kWhole) {             // cout == kCOB: the chunk is one run
      for (int e = tid; e < C::kWF / 4; e += kThreads)
        cp_async16(smem_u32(s_w + 4 * e), wsrc + 4 * e, true);
    } else {
      for (int e = tid; e < C::kWF / 4; e += kThreads) {
        const int row = e / (C::kCOB / 4), v = e % (C::kCOB / 4);   // row = c * Q + q
        cp_async16(smem_u32(s_w + row * C::kCOB + 4 * v),
                   wsrc + (int64_t)row * p.cout + co0 + 4 * v, true);
      }
    }
  };

  float acc[2][2][PX][CO];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < PX; ++i)
#pragma unroll
        for (int j = 0; j < CO; ++j) acc[a][b][i][j] = 0.f;

  const int nchunk = p.cin / C::kCC;
  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    const int s = k & 1;
    cp_async_wait<0>();          // chunk k has landed (this thread's copies)
    if (prologue) halo_chunk<C, true>(p, xn, effn, smem + s * C::kStage, k * C::kCC, iy0, ix0);
    __syncthreads();             // every copy and pass of chunk k is done; every
                                 // thread is done with chunk k - 1, in stage s ^ 1
    if (k + 1 < nchunk) {
      load(k + 1, s ^ 1);
      cp_async_commit();
    }
    const float* sx = smem + s * C::kStage + pr * C::kRow + pc;
    const float* sw = smem + s * C::kStage + C::kHalo;
#pragma unroll 1
    for (int c = 0; c < C::kCC; ++c) {
      int q = 0;                 // the packing's order: du, dv, a, b over the used ones
#pragma unroll
      for (int du = 0; du < S; ++du) {
        const float* xr = sx + (c * C::kHR + du) * C::kRow;
        float xv[C::kXV];
#pragma unroll
        for (int t = 0; t < C::kXV; t += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + t);
          xv[t] = v.x; xv[t + 1] = v.y; xv[t + 2] = v.z; xv[t + 3] = v.w;
        }
#pragma unroll
        for (int dv = 0; dv < S; ++dv) {
          if constexpr (C::kAll4) {    // the four phases' weights are one aligned run
            float w4[4 * CO];
            const float* src = sw + (c * F::kQ + q) * C::kCOB;
#pragma unroll
            for (int t = 0; t < 4 * CO; t += 4) {
              const float4 v = *reinterpret_cast<const float4*>(src + t);
              w4[t] = v.x; w4[t + 1] = v.y; w4[t + 2] = v.z; w4[t + 3] = v.w;
            }
            q += 4;
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int b = 0; b < 2; ++b)
#pragma unroll
                for (int i = 0; i < PX; ++i)
#pragma unroll
                  for (int j = 0; j < CO; ++j)
                    acc[a][b][i][j] = fmaf(xv[i + dv], w4[(2 * a + b) * CO + j], acc[a][b][i][j]);
          } else {
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                if (!F::used(du, a) || !F::used(dv, b)) continue;
                float wv[CO];
                load_w<C>(sw, c, q, cg, wv);
                ++q;
#pragma unroll
                for (int i = 0; i < PX; ++i)
#pragma unroll
                  for (int j = 0; j < CO; ++j)
                    acc[a][b][i][j] = fmaf(xv[i + dv], wv[j], acc[a][b][i][j]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: bias (and tanh), the stores at full resolution, the statistics
  float bias[CO], ssum[CO], ssq[CO];
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    bias[j] = p.b[co0 + cg * CO + j];
    ssum[j] = ssq[j] = 0.f;
  }
  const int hout = 2 * p.hin, wout = 2 * p.win;
  const int iy = y0 + pr;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int i = 0; i < PX; ++i) {
      const int ix = x0 + pc + i;
      if (iy >= p.hin || ix >= p.win) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float v[CO];
#pragma unroll
        for (int j = 0; j < CO; ++j) {
          v[j] = acc[a][b][i][j] + bias[j];
          if (p.apply_tanh) v[j] = tanhf(v[j]) * p.tanh_scale;
          ssum[j] += v[j];
          ssq[j] += v[j] * v[j];
        }
        float* yp = p.y + (((int64_t)n * hout + 2 * iy + a) * wout + 2 * ix + b) * p.cout
                    + co0 + cg * CO;
        if constexpr (CO % 4 == 0) {
#pragma unroll
          for (int j = 0; j < CO; j += 4)
            *reinterpret_cast<float4*>(yp + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < CO; ++j) yp[j] = v[j];
        }
      }
    }
  }
  if (!p.stats) return;               // uniform across the block
#pragma unroll
  for (int j = 0; j < CO; ++j) {      // lanes l, l ^ NCG, ... hold the same channels
#pragma unroll
    for (int m = NCG; m < 32; m <<= 1) {
      ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], m);
      ssq[j] += __shfl_xor_sync(0xffffffffu, ssq[j], m);
    }
  }
  if ((tid & 31) < NCG) {             // s_stat's zeroing was seen at the loop's barriers
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      atomicAdd(&s_stat[0][cg * CO + j], ssum[j]);
      atomicAdd(&s_stat[1][cg * CO + j], ssq[j]);
    }
  }
  __syncthreads();
  float* st = p.stats + (int64_t)n * 2 * p.cout;
  for (int e = tid; e < 2 * C::kCOB; e += kThreads)
    atomicAdd(&st[(e / C::kCOB) * p.cout + co0 + e % C::kCOB], s_stat[e / C::kCOB][e % C::kCOB]);
}

// Lift an instance's dynamic shared-memory limit and ask for the whole
// carveout (two blocks an SM), once per device.
template <class C>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  const void* fn = (const void*)upconv_f32_kernel<C>;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

template <class C>
int launch(const UpconvArgs& p, int n, cudaStream_t s) {
  if ((int64_t)n * (p.cout / C::kCOB) > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.win + C::kTW - 1) / C::kTW, (p.hin + C::kTH - 1) / C::kTH, n * (p.cout / C::kCOB));
  upconv_f32_kernel<C><<<grid, kThreads, C::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Nearest 2x upsample then a k x k stride-1 conv with zero pad (k - 1) / 2,
// folded, on n NHWC images (hin, win, cin) -> (2 hin, 2 win, cout) on the
// current device and `stream`: k 9 with cin % 4 == 0 and cout == 3, or k 3
// with cin % 8 == 0 and cout % 32 == 0. w packed by ops/upconv_kernel.py
// `pack_upconv_weights` and 16-byte aligned, as y is; eff (n, 2, cin) or
// null; stats (n, 2, cout) zeroed, or null; a nonzero apply_tanh applies
// tanh(.) * tanh_scale to the stored values, whatever tanh_scale's sign.
extern "C" int fav_upconv_f32(const void* x, const void* w, const void* b, const void* eff,
                              void* y, void* stats, int n, int hin, int win, int cin,
                              int cout, int k, int relu, int apply_tanh, float tanh_scale,
                              void* stream) {
  UpconvArgs p;
  p.x = (const float*)x; p.w = (const float*)w; p.b = (const float*)b;
  p.eff = (const float*)eff; p.y = (float*)y; p.stats = (float*)stats;
  p.hin = hin; p.win = win; p.cin = cin; p.cout = cout; p.relu = relu;
  p.apply_tanh = apply_tanh; p.tanh_scale = tanh_scale;
  if (n < 1 || hin < 1 || win < 1 || cin < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 9 && cin % K9Cfg::kCC == 0 && cout == K9Cfg::kCOB) return launch<K9Cfg>(p, n, s);
  if (k == 3 && cin % K3Cfg::kCC == 0 && cout % K3Cfg::kCOB == 0) return launch<K3Cfg>(p, n, s);
  return (int)cudaErrorInvalidValue;
}
