// Cellpose-SAM's residual add, the LayerNorm that follows it and that
// LayerNorm's cast to bf16, in one pass over the rows of the stream.
//
// Replaces no TPU kernel: the JAX package has no vision transformer.  Under
// bf16 autocast the ViT's residual stream (models/vit_sam.py) is float32 and
// each branch (the attention's proj, the MLP's lin2) returns bf16, so on the
// card each of the 48 norms of a forward had run as three PyTorch passes:
// the mixed add (a new float32 stream), LayerNorm in float32, and
// autocast's cast of its output to bf16 before the next linear layer.  Each
// pass read and wrote the whole stream: ~403 MB a norm at the cell's 16
// tiles of 1,024 tokens and D = 1,024.
//
// x holds `rows` rows of D float32 values, h (or NULL) as many of bf16.
// x is updated in place and y written:
//
//   x[r, c] = x[r, c] + float(h[r, c])         (one float32 rounding: the add
//                                               PyTorch runs for x + h)
//   y[r, c] = bf16(weight[c] * (rstd * (x[r, c] - mean)) + bias[c])
//   mean = sum_c x[r, c] / D,  rstd = rsqrt(sum_c (x[r, c] - mean)^2 / D + eps)
//
// in float32, y rounded once to nearest even, as autocast rounds a linear
// layer's input.  The output expression is that of PyTorch's vectorized
// LayerNorm kernel; there the mean and variance come from Welford's update,
// summed in another order, so y may differ from it by one bf16 step where a
// float32 sum rounds the other way.
//
// What bounds it on the H100: the bytes, x and h read once, x and y written
// once, 12 D bytes a row with h and 6 D without (201 MB a norm at the cell's
// shape, 60 us at 3.35 TB/s); the arithmetic is a few operations an element.
// So the design streams: one warp a row, the row held in registers.  Lane l
// holds the quads of four columns q = l, l + 32, l + 64, ... (16-byte loads
// of x, 8-byte loads of h and stores of y, each warp instruction on
// consecutive addresses) and starts every load of its row before the first
// sum.  Mean and variance are two passes over the registers, each a warp's
// shuffle sum, so HBM is read once; weight and bias (8 KB) are read per row
// from L1.  A block of 8 warps takes 8 rows and the grid covers the rows
// once: at the cell's shape that read 83.1% of the bound against 81.4% for a
// persistent grid walking the rows with its stride, in turns on one H100
// (the block scheduler fills the last wave finer than a warp's sixth row).
// A lane holds 8 quads, so D runs up to 1,024 (the cell's width; below it
// a lane's last quads sit idle, as at ViT-B's 768): a wider ViT needs a
// wider instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUADS = 8;   // quads a lane holds: D up to 32 * 8 * 4 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 b;
  memcpy(&b, &u, 4);
  return __bfloat1622float2(b);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &b, 4);
  return u;
}

// quads = D / 4 a row; lane l holds quad l + 32 j for j < J where it is
// below quads (below D = 1,024 a lane's last quads are idle).
template <int J, bool HAS_H>
__global__ void __launch_bounds__(THREADS)
add_layernorm_kernel(float4 *__restrict__ x, const uint2 *__restrict__ h,
                     const float4 *__restrict__ weight,
                     const float4 *__restrict__ bias, uint2 *__restrict__ y,
                     float eps, int rows, int quads) {
  const int lane = threadIdx.x & 31;
  const float d = (float)(4 * quads);
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  float4 *xr = x + r * quads;
  float4 v[J];
  uint2 hv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = lane + 32 * j;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    hv[j] = make_uint2(0u, 0u);
    if (q < quads) {
      v[j] = xr[q];
      if (HAS_H) hv[j] = h[r * quads + q];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = lane + 32 * j;
    if (q < quads) {
      if (HAS_H) {
        const float2 a = unpack_bf16x2(hv[j].x), b = unpack_bf16x2(hv[j].y);
        v[j].x = __fadd_rn(v[j].x, a.x);
        v[j].y = __fadd_rn(v[j].y, a.y);
        v[j].z = __fadd_rn(v[j].z, b.x);
        v[j].w = __fadd_rn(v[j].w, b.y);
        xr[q] = v[j];
      }
      s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
  }
  const float mean = __fdiv_rn(warp_sum(s), d);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < quads) {
      const float a = v[j].x - mean, b = v[j].y - mean, c = v[j].z - mean,
                  e = v[j].w - mean;
      ss += (a * a + b * b) + (c * c + e * e);
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), d), eps));
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = lane + 32 * j;
    if (q < quads) {
      const float4 w = __ldg(weight + q), b = __ldg(bias + q);
      const float o0 = w.x * (rstd * (v[j].x - mean)) + b.x;
      const float o1 = w.y * (rstd * (v[j].y - mean)) + b.y;
      const float o2 = w.z * (rstd * (v[j].z - mean)) + b.z;
      const float o3 = w.w * (rstd * (v[j].w - mean)) + b.w;
      y[r * quads + q] = make_uint2(pack_bf16x2(o0, o1), pack_bf16x2(o2, o3));
    }
  }
}

template <bool HAS_H>
static int run(float *x, const void *h, const float *weight,
               const float *bias, void *y, float eps, int rows, int quads,
               cudaStream_t stream) {
  const int blocks = (int)(((long long)rows + WARPS - 1) / WARPS);
  add_layernorm_kernel<QUADS, HAS_H><<<blocks, THREADS, 0, stream>>>(
      (float4 *)x, (const uint2 *)h, (const float4 *)weight,
      (const float4 *)bias, (uint2 *)y, eps, rows, quads);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows x dim float32, h: NULL or rows x dim bf16, y: rows x dim bf16,
// each contiguous and 16-byte aligned; weight, bias: dim float32 each.  dim
// is a multiple of 8 up to 1024; rows >= 1.  x is updated in place (where h
// is given) and y written.
extern "C" int add_layernorm_launch(void *x, const void *h,
                                    const void *weight, const void *bias,
                                    void *y, int rows, int dim, float eps,
                                    void *stream) {
  if (dim < 8 || dim % 8 || dim > 4 * 32 * QUADS || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (h)
    return run<true>((float *)x, h, (const float *)weight,
                     (const float *)bias, y, eps, rows, dim / 4,
                     (cudaStream_t)stream);
  return run<false>((float *)x, h, (const float *)weight,
                    (const float *)bias, y, eps, rows, dim / 4,
                    (cudaStream_t)stream);
}
