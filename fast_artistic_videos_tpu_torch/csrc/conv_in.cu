// Direct convolution for Hopper (sm_90a), plain C interface.
//
// Replaces, with one template, the Pallas kernels of every conv shape that
// no specialised kernel takes:
//   * fast_artistic_videos_tpu/ops/front_pallas.py `_kernel` (pallas_call in
//     `_same_conv`) — the stylizer front (K3) at the shapes that neither
//     front_f32.cu (float32 9x9 at Cin <= 8, Cout % 32; 3x3 stride 2 at Cin
//     % 8, Cout % 64: the stylizer's layers 0-2) nor front_tc.cu (the same
//     families in bfloat16) takes. The TPU runs the front in a 16-phase
//     space-to-depth layout to feed its 128-lane MXU; here it runs directly
//     on the logical NHWC grid;
//   * fast_artistic_videos_tpu/ops/rblock_pallas.py `_kernel` (pallas_call
//     in `_chain_conv`) — the residual chain's VALID 3x3 convs (K2), (kh,
//     kw, stride, pad) = (3, 3, 1, 0), at the widths that neither
//     conv3x3_f32.cu (float32, Cin % 8, Cout % 128) nor conv_tc.cu
//     (bfloat16, Cin % 64, Cout % 128) takes.
//
// y = conv(prologue(x), w) + b, with
//   prologue(x) = [+ skip[+2, +2]] ( [relu] ( eff[0] * x + eff[1] ) )
// applied per input channel (each step optional; values rounded to the
// storage dtype after the affine and after the skip add, as the Pallas
// kernels do). Zero padding is applied AFTER the prologue: a tap outside the
// input reads 0, not eff(0) (front_pallas.py:84-93). With `a` non-null the
// prologue result is also stored (the materialized residual-block input that
// the next block uses as its skip).
// Epilogue: bias, store in the storage dtype, and (with `stats` non-null)
// per-output-channel [sum; sum of squares] of the STORED (dtype-rounded)
// values, accumulated with atomics into an f32 (2, Cout) buffer that the
// caller zeroes — the instance-norm statistics of the next layer's prologue.
//
// Layout: NHWC activations, one image, HWIO weights (kh, kw, Cin, Cout), f32
// or bf16 storage, f32 accumulation. Which configurations run here is the
// rule of ops/_conv_in.py `conv_route`.
//
// What bounds it on the H100: CUDA-core FMAs (a front layer 0 of 84.2 GFLOP
// at 1080p, had it run here); no tensor cores are used here, so the
// roofline is the 67 TFLOP/s f32 FMA rate (float32 runs with TF32 off). Design: a
// block owns a 16 x 16 output tile x 32 output channels; the input halo
// (with the prologue applied once per element) and the weight slice for a
// chunk of input channels are staged in shared memory as f32; each of the
// 256 threads keeps 4 pixels x 8 channels of accumulators in registers, so
// every shared-memory load feeds 4-8 FMAs. Cross-block statistics need
// atomics: blocks run in no order (the TPU carried the sum across its
// sequential grid in scratch).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTH = 16;        // output tile rows
constexpr int kTW = 16;        // output tile cols
constexpr int kTCO = 32;       // output channels per block
constexpr int kThreads = 256;
constexpr int kPX = 4;         // output rows per thread
constexpr int kCO = 8;         // output channels per thread
constexpr int kSmemBudget = 100 * 1024;  // dynamic shared memory per block
constexpr int kMaxDevices = 64;

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
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

struct ConvArgs {
  const void* x;      // (hin, win, cin)
  const void* w;      // (kh, kw, cin, cout)
  const float* b;     // (cout,) already rounded to the storage dtype
  const float* eff;   // (2, cin) or null
  const void* skip;   // (hin + 4, win + 4, cin) or null
  void* y;            // (hout, wout, cout)
  float* stats;       // (2, cout), zeroed by the caller, or null
  void* a;            // (hin, win, cin) or null
  int hin, win, cin, hout, wout, cout;
  int kh, kw, stride, pad, relu;
  int cc;             // input channels per shared-memory pass (pick_chunk)
};

__host__ __device__ inline int halo(int tile, int stride, int k) {
  return (tile - 1) * stride + k;
}

__host__ __device__ inline int in_floats(int cc, int ih, int iw) {
  return (cc * ih * iw + 3) & ~3;  // keeps the weight slice 16-byte aligned
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_in_kernel(ConvArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float s_stat[2][kTCO];

  const int ih_t = halo(kTH, p.stride, p.kh);
  const int iw_t = halo(kTW, p.stride, p.kw);
  float* s_in = smem;                                  // [cc][ih_t][iw_t]
  float* s_w = smem + in_floats(p.cc, ih_t, iw_t);     // [kh*kw][cc][kTCO]

  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const T* skip = static_cast<const T*>(p.skip);
  T* y = static_cast<T*>(p.y);
  T* a = static_cast<T*>(p.a);
  float* stats = p.stats;

  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * kTW, oy0 = blockIdx.y * kTH;
  const int co0 = blockIdx.z * kTCO;
  const int iy0 = oy0 * p.stride - p.pad, ix0 = ox0 * p.stride - p.pad;
  const int cg = tid / 64;            // channel group: co0 + cg*8 .. +8
  const int pg = tid % 64;            // pixel group: col pg%16, rows +4
  const int lx = pg % kTW, ly0 = (pg / kTW) * kPX;

  if (stats && tid < 2 * kTCO) s_stat[tid / kTCO][tid % kTCO] = 0.f;

  float acc[kPX][kCO];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.f;

  // Emission: input pixels are partitioned among the tiles (tile t owns the
  // rows [iy0, iy0 + kTH*stride), the last tile everything to its halo end),
  // and only the first channel block writes, so each element is stored once.
  const bool emit = a != nullptr && co0 == 0;
  const bool last_y = blockIdx.y == gridDim.y - 1;
  const bool last_x = blockIdx.x == gridDim.x - 1;
  const int own_y1 = iy0 + kTH * p.stride, own_x1 = ix0 + kTW * p.stride;
  const int ntap = p.kh * p.kw;

  for (int c0 = 0; c0 < p.cin; c0 += p.cc) {
    __syncthreads();  // the previous chunk's readers are done
    const int n_in = p.cc * ih_t * iw_t;
    for (int e = tid; e < n_in; e += kThreads) {
      const int c = e % p.cc;
      const int pos = e / p.cc;
      const int r = pos / iw_t, q = pos % iw_t;
      const int iy = iy0 + r, ix = ix0 + q, ci = c0 + c;
      float v = 0.f;
      if (ci < p.cin && iy >= 0 && iy < p.hin && ix >= 0 && ix < p.win) {
        const int64_t off = ((int64_t)iy * p.win + ix) * p.cin + ci;
        v = to_f<T>(x[off]);
        if (p.eff) v = round_t<T>(v * p.eff[ci] + p.eff[p.cin + ci]);
        if (p.relu) v = fmaxf(v, 0.f);
        if (skip) {
          const int64_t so = ((int64_t)(iy + 2) * (p.win + 4) + ix + 2) * p.cin + ci;
          v = round_t<T>(v + to_f<T>(skip[so]));
        }
        if (emit && (iy < own_y1 || last_y) && (ix < own_x1 || last_x))
          a[off] = from_f<T>(v);
      }
      s_in[(c * ih_t + r) * iw_t + q] = v;
    }
    const int n_w = ntap * p.cc * kTCO;
    for (int e = tid; e < n_w; e += kThreads) {
      const int co = e % kTCO;
      const int rest = e / kTCO;
      const int c = rest % p.cc, tap = rest / p.cc;
      const int ci = c0 + c;
      float v = 0.f;
      if (ci < p.cin && co0 + co < p.cout)
        v = to_f<T>(w[((int64_t)tap * p.cin + ci) * p.cout + co0 + co]);
      s_w[(tap * p.cc + c) * kTCO + co] = v;
    }
    __syncthreads();

    for (int c = 0; c < p.cc; ++c) {
      const float* in_c = s_in + c * ih_t * iw_t;
      for (int u = 0; u < p.kh; ++u) {
        for (int v = 0; v < p.kw; ++v) {
          const float4* wp = reinterpret_cast<const float4*>(
              s_w + ((u * p.kw + v) * p.cc + c) * kTCO + cg * kCO);
          const float4 wa = wp[0], wb = wp[1];
          const float wv[kCO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
          const float* col = in_c + u * iw_t + lx * p.stride + v;
#pragma unroll
          for (int i = 0; i < kPX; ++i) {
            const float xv = col[(ly0 + i) * p.stride * iw_t];
#pragma unroll
            for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
          }
        }
      }
    }
  }

  // epilogue: bias, store, statistics of the stored values
  float ssum[kCO], ssq[kCO];
#pragma unroll
  for (int j = 0; j < kCO; ++j) ssum[j] = ssq[j] = 0.f;
  const int ox = ox0 + lx;
  const int cb = co0 + cg * kCO;  // this thread's first output channel
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int oy = oy0 + ly0 + i;
    if (oy < p.hout && ox < p.wout) {
      T* yp = y + ((int64_t)oy * p.wout + ox) * p.cout + cb;
#pragma unroll
      for (int j = 0; j < kCO; ++j) {
        if (cb + j < p.cout) {
          const float v = acc[i][j] + p.b[cb + j];
          const T st = from_f<T>(v);
          yp[j] = st;
          const float r = to_f<T>(st);
          ssum[j] += r;
          ssq[j] += r * r;
        }
      }
    }
  }
  if (!stats) return;  // uniform across the block: no barrier is skipped
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], m);
      ssq[j] += __shfl_xor_sync(0xffffffffu, ssq[j], m);
    }
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int j = 0; j < kCO; ++j) {
      atomicAdd(&s_stat[0][cg * kCO + j], ssum[j]);
      atomicAdd(&s_stat[1][cg * kCO + j], ssq[j]);
    }
  }
  __syncthreads();
  if (tid < 2 * kTCO) {
    const int k = tid / kTCO, co = tid % kTCO;
    if (co0 + co < p.cout) atomicAdd(&stats[k * p.cout + co0 + co], s_stat[k][co]);
  }
}

int smem_bytes(const ConvArgs& p) {
  const int ih = halo(kTH, p.stride, p.kh), iw = halo(kTW, p.stride, p.kw);
  return (in_floats(p.cc, ih, iw) + p.kh * p.kw * p.cc * kTCO) * (int)sizeof(float);
}

// Input channels staged per shared-memory pass: the largest power of two
// (<= 32, <= what cin needs) whose halo + weight slice fit kSmemBudget.
int pick_chunk(ConvArgs& p) {
  p.cc = 1;
  while (p.cc < p.cin && p.cc < 32) p.cc *= 2;
  while (p.cc > 1 && smem_bytes(p) > kSmemBudget) p.cc /= 2;
  return smem_bytes(p);
}

// Lift the kernel's dynamic shared-memory limit to kSmemBudget, once per
// device (the attribute is per device; setting it twice is harmless).
template <typename T>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(conv_in_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (e == cudaSuccess) done[dev].store(true);
  return e;
}

template <typename T>
int launch(ConvArgs& p, cudaStream_t s) {
  const int bytes = pick_chunk(p);
  if (bytes > kSmemBudget) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<T>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.wout + kTW - 1) / kTW, (p.hout + kTH - 1) / kTH, (p.cout + kTCO - 1) / kTCO);
  conv_in_kernel<T><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on the current device (the caller makes the tensors' device
// current) and `stream`: one image, prologue and statistics.
extern "C" int fav_conv_in(const void* x, const void* w, const void* b,
                           const void* eff, const void* skip, void* y,
                           void* stats, void* a, int hin, int win, int cin,
                           int hout, int wout, int cout, int kh, int kw,
                           int stride, int pad, int relu, int is_bf16,
                           void* stream) {
  if (cout < 1 || cin < 1) return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.x = x; p.w = w; p.b = (const float*)b; p.eff = (const float*)eff;
  p.skip = skip; p.y = y; p.stats = (float*)stats; p.a = a;
  p.hin = hin; p.win = win; p.cin = cin;
  p.hout = hout; p.wout = wout; p.cout = cout;
  p.kh = kh; p.kw = kw; p.stride = stride; p.pad = pad; p.relu = relu;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}
