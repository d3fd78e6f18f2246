// Connected components (K3) and root-rank relabel (K4) by union-find.
//
// Replaces the TPU kernels microbeseg_tpu/ops/pallas/propagate.py::
// cc_warmstart (_cc_window_kernel) and ::rank_warmstart
// (_rank_window_kernel), and the XLA sweep loops they warm-start
// (microbeseg_tpu/ops/cc.py::connected_components and
// ::sequentialize_components), at every frame size.
//
// K3: every pixel of a component gets the component's max linear index + 1
// (the unique fixed point of the JAX neighbour-max loop).  K4: every pixel
// with id L gets the rank of its root, the pixel at linear index L - 1
// holding L, when that root is 8-connected to it through pixels of id L
// (the fixed point of the JAX gated rank spread), else 0.
//
// What bounds it on the H100: memory, and below a few megapixels the
// latency of the launches.  The sweep loop it replaces costs one full-plane
// pass per unit of component diameter; union-find costs a near-constant
// number of passes.
//
// The union-find (cc_launch, rank_launch, ranked_launch): (1) every
// foreground pixel is its own root.  (2) every pixel unites with its
// neighbours above and to the left (the 4 of 8-connectivity that come
// earlier in raster order, 2 of 4-connectivity).  A union links the smaller
// root under the larger with atomicCAS(parent[small], small, large), so
// parents only grow, the forest stays acyclic, and every tree's root is its
// largest index; finds halve paths with atomicCAS too.  The final forest does
// not depend on the order the atomics ran in, only its shape does, and the
// result reads only the roots.  (3) each pixel finds its root and writes the
// result.
//
// ranked_launch is K4 for the ids that K3 makes, ranks straight from a mask:
// sequentialize_components(connected_components(mask)) from one forest.  For
// such ids a pixel's root is known (the root of its tree), is always present
// and always connected, so the general K4's second forest over equal ids, its
// two finds per pixel and the caller's compare, prefix sum and select over
// the plane all fall away.  Five launches, no ids plane:
//   1, 2  the forest, as above;
//   3     every pixel finds its root and stores it as its parent; a block of
//         256 pixels of one image counts its roots with warp ballots, writes
//         the count, and leaves at each root its index among the block's
//         roots, negated, in the output plane;
//   4     one block per image turns the block counts into an exclusive
//         prefix (256 counts at 256^2, 16,384 at 2048^2);
//   5     every foreground pixel reads the word at its root: a negative word
//         is the index pass 3 left, and block prefix + index + 1 is the rank;
//         a positive word is the rank the root has already written for
//         itself.  Both decode to the same rank, so the pass needs no order.
// The function reads 1 byte and writes 4 a pixel; the passes move 1 (mask) +
// 4 (parent, written) + 4 + 4 (parent, read and rewritten) + 4 + 4 (parent
// and root word read, rank written) = about 25 bytes a pixel, all of it in L2
// up to a few megapixels.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ int find_root(int *parent, int x) {
  while (true) {
    int p = __ldcg(parent + x);
    if (p == x) return x;
    int gp = __ldcg(parent + p);
    if (gp != p) atomicCAS(parent + x, p, gp);
    x = p;
  }
}

__device__ __forceinline__ void unite(int *parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) { int t = a; a = b; b = t; }
    // link the smaller root b under the larger root a, if b is still a root
    if (atomicCAS(parent + b, b, a) == b) return;
  }
}

// foreground / same-component predicates
struct MaskFg {
  const uint8_t *m;
  __device__ bool fg(long long p) const { return m[p] != 0; }
  __device__ bool same(long long p, long long q) const { return m[q] != 0; }
};
struct LabelFg {
  const int *l;
  __device__ bool fg(long long p) const { return l[p] > 0; }
  __device__ bool same(long long p, long long q) const { return l[q] == l[p]; }
};

template <class Fg>
__global__ void uf_init(Fg f, int *parent, long long n) {
  long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p < n) parent[p] = f.fg(p) ? (int)p : -1;
}

template <class Fg>
__global__ void uf_merge(Fg f, int *parent, int B, int H, int W, int diag) {
  long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long n = (long long)B * H * W;
  if (p >= n || !f.fg(p)) return;
  int c = (int)(p % W);
  int r = (int)((p / W) % H);
  if (c > 0 && f.same(p, p - 1)) unite(parent, (int)p, (int)(p - 1));
  if (r > 0) {
    if (f.same(p, p - W)) unite(parent, (int)p, (int)(p - W));
    if (diag) {
      if (c > 0 && f.same(p, p - W - 1)) unite(parent, (int)p, (int)(p - W - 1));
      if (c < W - 1 && f.same(p, p - W + 1)) unite(parent, (int)p, (int)(p - W + 1));
    }
  }
}

__global__ void cc_finish(int *parent, int *out, long long n, int HW) {
  long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  if (__ldcg(parent + p) < 0) {
    out[p] = 0;
    return;
  }
  int root = find_root(parent, (int)p);
  out[p] = root - (int)(p / HW) * HW + 1;
}

__global__ void rank_finish(const int *labels, const int *rank0, int *parent,
                            int *out, long long n, int HW) {
  long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  int L = labels[p];
  int res = 0;
  if (L > 0 && L <= HW) {
    long long base = (p / HW) * HW;
    long long rp = base + L - 1;  // the only pixel that can be L's root
    if (labels[rp] == L &&
        find_root(parent, (int)p) == find_root(parent, (int)rp))
      res = rank0[rp];
  }
  out[p] = res;
}

// Pass 3 of ranked_launch.  A block covers THREADS consecutive pixels of one
// image; bpi blocks an image.
__global__ void ranked_finish(int *parent, int *out, int *counts, int HW,
                              int bpi) {
  __shared__ int warp_roots[THREADS / 32];
  int img = blockIdx.x / bpi;
  int q = (blockIdx.x % bpi) * THREADS + threadIdx.x;
  long long p = (long long)img * HW + q;
  bool root = false;
  if (q < HW && __ldcg(parent + p) >= 0) {
    int r = find_root(parent, (int)p);
    root = r == (int)p;
    // an ancestor, so a find that passes through p still ends at the root
    if (!root) parent[p] = r;
  }
  unsigned ballot = __ballot_sync(0xffffffffu, root);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_roots[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    int c = warp_roots[w];
    if (w < warp) before += c;
    total += c;
  }
  if (root) out[p] = -(before + __popc(ballot & ((1u << lane) - 1u)) + 1);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Pass 4: counts (B, bpi) -> exclusive prefix along each image, in place.
__global__ void ranked_scan(int *counts, int bpi) {
  __shared__ int warp_sum[32];
  int *c = counts + (long long)blockIdx.x * bpi;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < bpi; base += 1024) {
    int i = base + threadIdx.x;
    int v = i < bpi ? c[i] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (i < bpi) c[i] = carry + x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
    carry += warp_sum[31];
    __syncthreads();
  }
}

// Pass 5: the rank stored at each pixel's root.
__global__ void ranked_write(const int *parent, int *out, const int *counts,
                             int HW, int bpi) {
  int img = blockIdx.x / bpi;
  int q = (blockIdx.x % bpi) * THREADS + threadIdx.x;
  if (q >= HW) return;
  long long base = (long long)img * HW;
  long long p = base + q;
  int r = parent[p];
  if (r < 0) {
    out[p] = 0;
    return;
  }
  int word = __ldcg(out + r);
  if (word < 0) {
    int rq = (int)(r - base);
    word = __ldg(counts + (long long)img * bpi + rq / THREADS) - word;
  }
  out[p] = word;
}

static inline unsigned blocks_for(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" int cc_launch(const void *mask, void *parent, void *out, int B,
                         int H, int W, int connectivity, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long n = (long long)B * H * W;
  if (n == 0) return 0;
  MaskFg f{(const uint8_t *)mask};
  uf_init<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, n);
  uf_merge<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, B, H, W,
                                             connectivity == 2);
  cc_finish<<<blocks_for(n), THREADS, 0, s>>>((int *)parent, (int *)out, n,
                                              H * W);
  return (int)cudaGetLastError();
}

extern "C" int rank_launch(const void *labels, const void *rank0,
                           void *parent, void *out, int B, int H, int W,
                           void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long n = (long long)B * H * W;
  if (n == 0) return 0;
  LabelFg f{(const int *)labels};
  uf_init<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, n);
  uf_merge<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, B, H, W, 1);
  rank_finish<<<blocks_for(n), THREADS, 0, s>>>(
      (const int *)labels, (const int *)rank0, (int *)parent, (int *)out, n,
      H * W);
  return (int)cudaGetLastError();
}

// mask (B, H, W) bytes -> out (B, H, W) int32 ranks 1..n of each pixel's
// component, in raster order of the components' last pixels.  parent is
// scratch of B * H * W int32, counts of B * ceil(H * W / 256) int32.
extern "C" int ranked_launch(const void *mask, void *parent, void *out,
                             void *counts, int B, int H, int W,
                             int connectivity, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long n = (long long)B * H * W;
  if (n == 0) return 0;
  int HW = H * W;
  int bpi = (HW + THREADS - 1) / THREADS;
  unsigned blocks = (unsigned)B * (unsigned)bpi;
  MaskFg f{(const uint8_t *)mask};
  uf_init<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, n);
  uf_merge<<<blocks_for(n), THREADS, 0, s>>>(f, (int *)parent, B, H, W,
                                             connectivity == 2);
  ranked_finish<<<blocks, THREADS, 0, s>>>((int *)parent, (int *)out,
                                           (int *)counts, HW, bpi);
  ranked_scan<<<B, 1024, 0, s>>>((int *)counts, bpi);
  ranked_write<<<blocks, THREADS, 0, s>>>((const int *)parent, (int *)out,
                                          (const int *)counts, HW, bpi);
  return (int)cudaGetLastError();
}
