// Register-tiled float32 3x3 stride-1 convolution for Hopper (sm_90a) on
// the CUDA cores; plain C interface.
//
// Replaces, in float32 at Cin % 8 == 0 and Cout % 128 == 0 (the routing
// rule of ops/_conv_in.py `conv_route`):
//   * fast_artistic_videos_tpu/ops/rblock_pallas.py:69 `_kernel` (K2) — the
//     residual chain's VALID conv at batch 1, with its prologue
//     [+ skip[+2, +2]] ( [relu] ( eff[0] * x + eff[1] ) ), the optional
//     emission of the prologue result `a`, and the instance-norm statistics
//     of the stored output;
//   * fast_artistic_videos_tpu/ops/conv_pallas.py:40 `_conv3x3_kernel` (K4)
//     — the block conv of a batch, SAME (pad 1, the zero border read through
//     the loads) or VALID, bias, optional ReLU epilogue, the whole batch in
//     one launch.
// Bfloat16 K2/K4 run on the tensor cores (conv_tc.cu); the float32 front
// (K3: 9x9, stride 2) runs in front_f32.cu, other widths on conv_in.cu.
//
// Semantics are those of conv_in.cu: the prologue's multiply, add and skip
// add are separate float32 operations (__fmul_rn / __fadd_rn), as PyTorch
// computes the plain version, so `a` equals it bit for bit; zero padding
// comes after the prologue (a tap outside the image reads 0, not eff(0));
// y = acc + b with the optional ReLU; the statistics are float32 [sum; sum
// of squares] of the stored outputs per channel, added with atomics into a
// (2, Cout) buffer per image that the caller zeroes.
//
// What bounds it on the H100: operations. Float32 runs with TF32 off, so
// the rate is the CUDA cores' 67 TFLOP/s of FMAs: a K2 conv at 290x500
// (output 288x498) is 42.3 GFLOP, 0.631 ms; the batched K4 conv of four
// such frames 169.2 GFLOP, 2.525 ms. The bytes take a twentieth of that.
// So the design keeps the FMA pipes fed and spends few instructions on
// anything else:
//   * a block owns 8 x 16 output pixels x 128 output channels, so at Cout
//     128 each input element is loaded, and put through the prologue, once
//     (Cout 256 takes two channel blocks); 256 threads, each with an 8-pixel
//     (eight neighbouring columns of one row) x 8-channel register tile;
//   * the taps are compile-time constants and unrolled. For each input
//     channel and kernel row, a thread loads its ten halo values once (two
//     LDS.128 and one LDS.64) and the three taps' weights (two LDS.128
//     each): 192 FMAs for 9 loads;
//   * shared memory holds the halo channel-major ([c][10 rows][20], rows
//     16-byte aligned) and the weights as [c][tap][128 Cout]. A thread's 8
//     channels are 4cg..4cg+3 and 64+4cg..64+4cg+3, so a warp's weight load
//     is 256 contiguous bytes (two wavefronts) and its two halo addresses
//     fall in different banks;
//   * input channels come in chunks of 8 (43 KB of halo, skip halo and
//     weights), double-buffered: cp.async brings chunk k + 1 (4-byte copies
//     into the channel-major halo, zero-filled outside the image; 16-byte
//     copies of the weights) while chunk k is multiplied. Two stages take
//     97 KB, so two blocks (16 warps) run on each SM, at most 128 registers
//     a thread;
//   * K2's prologue runs in place over the arrived chunk: each thread
//     transforms the elements it copied itself, so no barrier is needed
//     between the copy and the pass, and writes `a` for the pixels its tile
//     owns (tile t owns input rows and columns [t * tile, (t + 1) * tile),
//     the last tile everything to its halo end; only the first channel block
//     writes);
//   * the weights are packed once per tensor version by the wrapper into
//     (Cin, 3, 3, Cout), so a chunk's weight slice is 72 rows of contiguous
//     Cout;
//   * the epilogue stores two 16-byte vectors per pixel; each thread sums
//     its 8 channels' stored values and squares, a shuffle and shared-memory
//     atomics reduce them, and one float32 atomicAdd per channel per block
//     reaches the statistics buffer (blocks run in no order).

#include <atomic>

#include "tc_common.cuh"

namespace {

constexpr int kTH = 8;                      // output tile rows
constexpr int kTW = 16;                     // output tile columns
constexpr int kHH = kTH + 2;                // halo rows
constexpr int kHW = kTW + 2;                // halo columns
constexpr int kRow = 20;                    // halo row stride (floats, 16-byte rows)
constexpr int kN = 128;                     // output channels per block
constexpr int kCC = 8;                      // input channels per chunk
constexpr int kThreads = 256;
constexpr int kPX = 8;                      // pixels per thread (one row)
constexpr int kCO = 8;                      // output channels per thread
constexpr int kInF = kCC * kHH * kRow;      // 1600 floats: one halo chunk
constexpr int kWF = kCC * 9 * kN;           // 9216 floats: one weight chunk
constexpr int kStageF = 2 * kInF + kWF;     // halo, skip halo, weights
constexpr int kSmem = 2 * kStageF * (int)sizeof(float);   // two stages: 99,328 B
constexpr int kHaloEl = kCC * kHH * kHW;    // elements copied per halo chunk
constexpr int kMaxDevices = 64;

static_assert(kTH * 2 == kThreads / 16 && kTW == 2 * kPX, "thread tile mapping");
static_assert((kWF / 4) % kThreads == 0, "weight copies per thread");

struct F32Args {
  const float* x;      // (n, hin, win, cin)
  const float* w;      // (cin, 3, 3, cout)
  const float* b;      // (cout,)
  const float* eff;    // (2, cin) or null
  const float* skip;   // (hin + 4, win + 4, cin) or null (n == 1)
  float* y;            // (n, hout, wout, cout)
  float* stats;        // (n, 2, cout) zeroed, or null
  float* a;            // (hin, win, cin) or null (n == 1)
  int n, hin, win, cin, hout, wout, cout, pad, relu, out_relu;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2) conv3x3_f32_kernel(F32Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_stat[2][kN];

  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = tid & 15;                 // channels 4cg.. and 64 + 4cg..
  const int pr = tid >> 5;                 // output row of the tile
  const int pc = ((tid >> 4) & 1) * kPX;   // first output column of the tile
  const int co_blocks = p.cout / kN;
  const int img = blockIdx.z / co_blocks;
  const int co0 = (blockIdx.z % co_blocks) * kN;
  const int oy0 = blockIdx.y * kTH, ox0 = blockIdx.x * kTW;
  const int iy0 = oy0 - p.pad, ix0 = ox0 - p.pad;
  const float* x = p.x + (int64_t)img * p.hin * p.win * p.cin;
  float* y = p.y + (int64_t)img * p.hout * p.wout * p.cout;
  float* stats = p.stats ? p.stats + (int64_t)img * 2 * p.cout : nullptr;
  const bool prologue = p.eff != nullptr || p.relu || p.skip != nullptr || p.a != nullptr;
  const bool emit = p.a != nullptr && co0 == 0;
  const bool last_y = blockIdx.y == gridDim.y - 1, last_x = blockIdx.x == gridDim.x - 1;

  s_stat[tid >> 7][tid & 127] = 0.f;

  // chunk k of the halo (and skip halo) and of the weights into stage s
  auto load = [&](int k, int s) {
    float* s_in = smem + s * kStageF;
    const int c0 = k * kCC;
    for (int e = tid; e < kHaloEl; e += kThreads) {
      const int c = e & (kCC - 1), px = e / kCC;
      const int hr = px / kHW, hq = px % kHW;
      const int iy = iy0 + hr, ix = ix0 + hq;
      const bool ok = iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win;
      const int so = (c * kHH + hr) * kRow + hq;
      cp_async4(smem_u32(s_in + so), ok ? x + ((int64_t)iy * p.win + ix) * p.cin + c0 + c : x,
                ok);
      if (p.skip)
        cp_async4(smem_u32(s_in + kInF + so),
                  ok ? p.skip + ((int64_t)(iy + 2) * (p.win + 4) + ix + 2) * p.cin + c0 + c
                     : p.skip,
                  ok);
    }
    const float* wsrc = p.w + (int64_t)c0 * 9 * p.cout + co0;
    float* s_w = s_in + 2 * kInF;
#pragma unroll
    for (int i = 0; i < kWF / 4 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int row = e >> 5, q = e & 31;          // row = c * 9 + tap
      cp_async16(smem_u32(s_w + row * kN + q * 4), wsrc + (int64_t)row * p.cout + q * 4, true);
    }
  };
  // K2's prologue in place over the elements this thread copied of chunk k
  // (outside the image the zero fill stays: padding comes after it)
  auto prologue_pass = [&](int k, int s) {
    float* s_in = smem + s * kStageF;
    const int c0 = k * kCC;
    for (int e = tid; e < kHaloEl; e += kThreads) {
      const int c = e & (kCC - 1), px = e / kCC;
      const int hr = px / kHW, hq = px % kHW;
      const int iy = iy0 + hr, ix = ix0 + hq;
      if (iy < 0 || iy >= p.hin || ix < 0 || ix >= p.win) continue;
      const int so = (c * kHH + hr) * kRow + hq, ci = c0 + c;
      float v = s_in[so];
      if (p.eff) v = __fadd_rn(__fmul_rn(v, p.eff[ci]), p.eff[p.cin + ci]);
      if (p.relu) v = fmaxf(v, 0.f);
      if (p.skip) v = __fadd_rn(v, s_in[kInF + so]);
      s_in[so] = v;
      if (emit && (iy < iy0 + kTH || last_y) && (ix < ix0 + kTW || last_x))
        p.a[((int64_t)iy * p.win + ix) * p.cin + ci] = v;
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
    if (prologue) prologue_pass(k, s);
    __syncthreads();             // every copy and pass of chunk k is done; every
                                 // thread is done with chunk k - 1, in stage s ^ 1
    if (k + 1 < nchunk) {
      load(k + 1, s ^ 1);
      cp_async_commit();
    }
    const float* sx = smem + s * kStageF + pr * kRow + pc;
    const float* sw = smem + s * kStageF + 2 * kInF + 4 * cg;
#pragma unroll 2
    for (int c = 0; c < kCC; ++c) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float* xr = sx + (c * kHH + u) * kRow;
        const float4 x0 = *reinterpret_cast<const float4*>(xr);
        const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
        const float2 x2 = *reinterpret_cast<const float2*>(xr + 8);
        const float xv[kPX + 2] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, x2.x, x2.y};
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float* wr = sw + (c * 9 + u * 3 + v) * kN;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 64);
          const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < kPX; ++i)
#pragma unroll
            for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv[i + v], wv[j], acc[i][j]);
        }
      }
    }
  }

  // epilogue: bias, ReLU, two 16-byte stores per pixel, statistics of the
  // stored values
  float bias[kCO], ssum[kCO], ssq[kCO];
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    bias[j] = p.b[co0 + (j & 4) * 16 + 4 * cg + (j & 3)];
    ssum[j] = ssq[j] = 0.f;
  }
  const int oy = oy0 + pr;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int ox = ox0 + pc + i;
    if (oy >= p.hout || ox >= p.wout) continue;
    float v[kCO];
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      v[j] = acc[i][j] + bias[j];
      if (p.out_relu) v[j] = fmaxf(v[j], 0.f);
      ssum[j] += v[j];
      ssq[j] += v[j] * v[j];
    }
    float* yp = y + ((int64_t)oy * p.wout + ox) * p.cout + co0 + 4 * cg;
    *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(yp + 64) = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (!stats) return;                 // uniform across the block
#pragma unroll
  for (int j = 0; j < kCO; ++j) {     // lanes l and l ^ 16 hold the same channels
    ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], 16);
    ssq[j] += __shfl_xor_sync(0xffffffffu, ssq[j], 16);
  }
  if (lane < 16) {                    // s_stat's zeroing was seen at the loop's barriers
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      const int co = (j & 4) * 16 + 4 * cg + (j & 3);
      atomicAdd(&s_stat[0][co], ssum[j]);
      atomicAdd(&s_stat[1][co], ssq[j]);
    }
  }
  __syncthreads();
  atomicAdd(&stats[(tid >> 7) * p.cout + co0 + (tid & 127)], s_stat[tid >> 7][tid & 127]);
}

// Lift the kernel's dynamic shared-memory limit to kSmem and ask for the
// whole shared-memory carveout (two blocks per SM), once per device.
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(conv3x3_f32_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

}  // namespace

// 3x3 stride-1 conv of n float32 NHWC images (n, hin, win, cin) -> (n, hout,
// wout, cout), hout = hin + 2 pad - 2, on the current device and `stream`.
// K2: n = 1, pad 0, any of eff / relu / skip / a / stats. K4: eff, skip, a
// and stats null, out_relu the epilogue ReLU. w is (cin, 3, 3, cout); w and
// y 16-byte aligned; cin % 8 == 0, cout % 128 == 0.
extern "C" int fav_conv3x3_f32(const void* x, const void* w, const void* b, const void* eff,
                               const void* skip, void* y, void* stats, void* a, int n,
                               int hin, int win, int cin, int cout, int pad, int relu,
                               int out_relu, void* stream) {
  if (n < 1 || cin < kCC || cin % kCC || cout < kN || cout % kN || pad < 0 || pad > 1)
    return (int)cudaErrorInvalidValue;
  if ((skip || a) && n != 1) return (int)cudaErrorInvalidValue;
  F32Args p;
  p.x = (const float*)x; p.w = (const float*)w; p.b = (const float*)b;
  p.eff = (const float*)eff; p.skip = (const float*)skip;
  p.y = (float*)y; p.stats = (float*)stats; p.a = (float*)a;
  p.n = n; p.hin = hin; p.win = win; p.cin = cin; p.cout = cout; p.pad = pad;
  p.hout = hin + 2 * pad - 2; p.wout = win + 2 * pad - 2;
  p.relu = relu; p.out_relu = out_relu;
  if (p.hout < 1 || p.wout < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const long long zblocks = (long long)n * (cout / kN);
  if (zblocks > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((p.wout + kTW - 1) / kTW, (p.hout + kTH - 1) / kTH, (unsigned)zblocks);
  conv3x3_f32_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
