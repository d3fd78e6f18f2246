// Cellpose's Euler steps through a flow field, every point's steps in one
// launch (cellpose/dynamics.py::steps_interp, release 4).
//
// Replaces no TPU kernel: the JAX package has no flows post-processing.
// Cellpose follows the points with one torch grid_sample and two clamps a
// step, some 600 launches for 200 steps; here each thread takes one point
// through all `niter` steps with its position in registers.
//
// field holds H x W pairs (x, y), row-major: the masked flow field
// dP * (cellprob > threshold) / 5, each component scaled by 2 / (size - 1)
// of its axis, as steps_interp scales its `im`.  pts holds n points (x, y)
// in grid_sample's normalised coordinates, in [-1, 1]; in place, each
// takes `niter` steps of
//
//   d = bilinear sample of field at p (grid_sample: align_corners=False,
//       zeros outside the frame)
//   p = clamp(p + d, -1, 1)   component by component.
//
// The sample is grid_sample's arithmetic for one point: the source index
// ((p + 1) * size - 1) / 2, its floor, the four weights as products of the
// distances to the corners, and each in-bounds corner's value times its
// weight added in the order nw, ne, sw, se, all in float32.
//
// What bounds it on the H100: the steps of one point depend on each other,
// so a thread waits on one L2 read after another; the 2048^2 field (32 MB)
// stays in the 50 MB L2, and neighbouring threads hold neighbouring pixels,
// whose paths run to the same sinks.  The work is some 40 float32
// operations a step, which the card's non-tensor float32 rate bounds from
// below (benchmark/metrics/follow_flows_roofline.py counts them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

__device__ __forceinline__ void tap(const float2 *__restrict__ field, int H,
                                    int W, int y, int x, float w, float &ax,
                                    float &ay) {
  if (inside(y, x, H, W)) {
    float2 v = __ldg(field + (int64_t)y * W + x);
    ax += v.x * w;
    ay += v.y * w;
  }
}

__global__ void __launch_bounds__(THREADS)
    follow_flows_kernel(const float2 *__restrict__ field, float2 *pts, int n,
                        int H, int W, int niter) {
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float2 p = pts[i];
  for (int t = 0; t < niter; ++t) {
    float ix = ((p.x + 1.f) * W - 1.f) / 2.f;
    float iy = ((p.y + 1.f) * H - 1.f) / 2.f;
    int x0 = (int)floorf(ix), y0 = (int)floorf(iy);
    int x1 = x0 + 1, y1 = y0 + 1;
    float nw = ((float)x1 - ix) * ((float)y1 - iy);
    float ne = (ix - (float)x0) * ((float)y1 - iy);
    float sw = ((float)x1 - ix) * (iy - (float)y0);
    float se = (ix - (float)x0) * (iy - (float)y0);
    float dx = 0.f, dy = 0.f;
    tap(field, H, W, y0, x0, nw, dx, dy);
    tap(field, H, W, y0, x1, ne, dx, dy);
    tap(field, H, W, y1, x0, sw, dx, dy);
    tap(field, H, W, y1, x1, se, dx, dy);
    p.x = fminf(fmaxf(p.x + dx, -1.f), 1.f);
    p.y = fminf(fmaxf(p.y + dy, -1.f), 1.f);
  }
  pts[i] = p;
}

}  // namespace

// field: H * W float2, pts: n float2 (in place).  Returns
// cudaGetLastError() after the launch.
extern "C" int follow_flows_launch(const void *field, void *pts, int n, int H,
                                   int W, int niter, void *stream) {
  if (n > 0 && niter > 0) {
    follow_flows_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float2 *)field, (float2 *)pts, n, H, W, niter);
  }
  return (int)cudaGetLastError();
}
