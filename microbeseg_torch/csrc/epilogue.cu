// The epilogue of a convolution that an activation and an eval-mode
// BatchNorm follow, in one pass over the convolution's output.
//
// Replaces no TPU kernel: XLA fuses the bias add, the activation and the
// normalisation into the convolution's consumers on the TPU, while on the
// card PyTorch runs them as three passes after cuDNN's convolution (the
// broadcast bias add, the activation, BatchNorm's channels-last transform),
// each of which reads and writes the whole activation.
//
// z holds `rows` pixels of C channels, channels-last and contiguous, in
// bfloat16 or float32: the convolution's output without its bias.  In place,
//
//   z[p, c] = act(z[p, c] + bias[c]) * a[c] + b[c],
//   a[c] = weight[c] * rsqrt(running_var[c] + eps),
//   b[c] = beta[c] - running_mean[c] * a[c],
//
// all in float32, each product and sum rounded on its own as PyTorch's
// separate operators round it (no fused multiply-add), and rounded once to
// z's type at the end.  The parameters are float32 and read as they are, so
// nothing is prepared on the host and nothing cached can go stale.  act is
// identity, relu, leakyrelu (slope 0.01), elu (alpha 1) or mish in the
// one-exp form of models/blocks.py::mish.
//
// What bounds it on the H100: the bytes, one read and one write of z (4 B an
// element in bfloat16, 8 B in float32, over 3.35 TB/s); the arithmetic is a
// few operations an element.  So the design streams: each thread moves 16
// bytes a load and a store (8 bfloat16 or 4 float32 channels), keeps its
// channel slot across a grid-stride loop over pixels, and so keeps the
// factors of its channels in registers; a warp's lanes cover consecutive
// 16-byte words, and each thread has UNROLL loads in flight before it
// computes.  A persistent grid of as many blocks as the card holds at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { IDENTITY = 0, RELU = 1, LEAKYRELU = 2, ELU = 3, MISH = 4 };

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // 16-byte loads in flight a thread

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == RELU) return x < 0.f ? 0.f : x;   // keeps NaN, as clamp_min does
  if (ACT == LEAKYRELU) return x > 0.f ? x : __fmul_rn(x, 0.01f);
  if (ACT == ELU) return x > 0.f ? x : expm1f(x);
  if (ACT == MISH) {
    float u = expf(fminf(x, 12.f));
    float v = __fmul_rn(u, __fadd_rn(u, 2.f));
    float t = x > 12.f ? 1.f : __fdiv_rn(v, __fadd_rn(v, 2.f));
    return __fmul_rn(x, t);
  }
  return x;
}

// 16 bytes of T as N float32 values and back
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4 &w, float *f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float *f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4 &w, float *f) {
    const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float *f) {
    uint4 w;
    __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return w;
  }
};

// groups = C / N words a pixel; a block's threads cover px = blockDim.x /
// groups pixels a pass, thread t the word t % groups of pixel t / groups.
template <int ACT, typename T>
__global__ void __launch_bounds__(THREADS)
epilogue_kernel(uint4 *__restrict__ z, const float *__restrict__ bias,
                const float *__restrict__ weight, const float *__restrict__ beta,
                const float *__restrict__ mean, const float *__restrict__ var,
                float eps, int rows, int groups) {
  constexpr int N = Pack<T>::N;
  const int slot = threadIdx.x % groups;
  const int px = blockDim.x / groups;
  const int lane_px = threadIdx.x / groups;
  if (lane_px >= px) return;   // the threads past the block's last whole pixel
  float cb[N], a[N], b[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = slot * N + i;
    cb[i] = bias[c];
    a[i] = __fmul_rn(weight[c], rsqrtf(__fadd_rn(var[c], eps)));
    b[i] = __fsub_rn(beta[c], __fmul_rn(mean[c], a[i]));
  }
  const long long step = (long long)gridDim.x * px * UNROLL;
  for (long long p0 = (long long)blockIdx.x * px * UNROLL + lane_px; p0 < rows;
       p0 += step) {
    uint4 w[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long p = p0 + (long long)k * px;
      if (p < rows) w[k] = z[p * groups + slot];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long p = p0 + (long long)k * px;
      if (p < rows) {
        float f[N];
        Pack<T>::unpack(w[k], f);
#pragma unroll
        for (int i = 0; i < N; ++i)
          f[i] = __fadd_rn(__fmul_rn(activate<ACT>(__fadd_rn(f[i], cb[i])), a[i]), b[i]);
        z[p * groups + slot] = Pack<T>::pack(f);
      }
    }
  }
}

// The card's SMs, looked up once per device.
static cudaError_t sm_count(int *sms) {
  static int cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) cache[dev] = *sms;
  return e;
}

template <int ACT, typename T>
static int run(void *z, const float *bias, const float *weight,
               const float *beta, const float *mean, const float *var,
               float eps, int rows, int channels, cudaStream_t stream) {
  // the blocks of this instance an SM holds at once, looked up once
  static int per_sm = 0;
  cudaError_t e;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, epilogue_kernel<ACT, T>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  int sms = 0;
  if ((e = sm_count(&sms)) != cudaSuccess) return (int)e;
  const int groups = channels / Pack<T>::N;
  const int threads = groups * (THREADS / groups);
  const long long per_block = (long long)(threads / groups) * UNROLL;
  const long long need = (rows + per_block - 1) / per_block;
  const int blocks = (int)(need < (long long)sms * per_sm ? need : (long long)sms * per_sm);
  epilogue_kernel<ACT, T><<<blocks, threads, 0, stream>>>(
      (uint4 *)z, bias, weight, beta, mean, var, eps, rows, groups);
  return (int)cudaGetLastError();
}

template <typename T>
static int run_act(int act, void *z, const float *bias, const float *weight,
                   const float *beta, const float *mean, const float *var,
                   float eps, int rows, int channels, cudaStream_t stream) {
  switch (act) {
    case IDENTITY:
      return run<IDENTITY, T>(z, bias, weight, beta, mean, var, eps, rows, channels, stream);
    case RELU:
      return run<RELU, T>(z, bias, weight, beta, mean, var, eps, rows, channels, stream);
    case LEAKYRELU:
      return run<LEAKYRELU, T>(z, bias, weight, beta, mean, var, eps, rows, channels, stream);
    case ELU:
      return run<ELU, T>(z, bias, weight, beta, mean, var, eps, rows, channels, stream);
    case MISH:
      return run<MISH, T>(z, bias, weight, beta, mean, var, eps, rows, channels, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// z: rows x channels values, channels-last and contiguous, bfloat16
// (is_bf16) or float32, 16-byte aligned; bias, weight, beta, mean, var:
// channels float32 values each.  channels is a multiple of 8 (bfloat16) or 4
// (float32) and at most 256 16-byte words; rows >= 1.  act: 0 identity,
// 1 relu, 2 leakyrelu, 3 elu, 4 mish.
extern "C" int conv_epilogue_launch(void *z, const void *bias,
                                    const void *weight, const void *beta,
                                    const void *mean, const void *var,
                                    int rows, int channels, int act,
                                    int is_bf16, float eps, void *stream) {
  const float *cb = (const float *)bias, *w = (const float *)weight,
              *bt = (const float *)beta, *m = (const float *)mean,
              *v = (const float *)var;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return run_act<__nv_bfloat16>(act, z, cb, w, bt, m, v, eps, rows, channels, s);
  return run_act<float>(act, z, cb, w, bt, m, v, eps, rows, channels, s);
}
