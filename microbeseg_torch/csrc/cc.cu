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
// (the fixed point of the JAX gated rank spread), else 0.  The ranks
// themselves (a prefix count of the roots) come in from the caller.
//
// What bounds it on the H100: memory.  The function reads one byte (K3) or
// one int32 (K4) per pixel and writes one int32; the union-find adds a
// parent plane that stays in L2, with a few dependent reads per pixel.
// The sweep loop it replaces costs one full-plane pass per unit of
// component diameter; union-find costs a near-constant number of passes.
//
// Design: three launches on one stream.  (1) every foreground pixel is its
// own root.  (2) every pixel unites with its neighbours above and to the
// left (the 4 of 8-connectivity that come earlier in raster order, 2 of
// 4-connectivity).  A union links the smaller root under the larger with
// atomicCAS(parent[small], small, large), so parents only grow, the forest
// stays acyclic, and every tree's root is its largest index; finds halve
// paths with atomicCAS too.  The final forest does not depend on the order
// the atomics ran in, only its shape does, and the result reads only the
// roots.  (3) each pixel finds its root and writes the result.

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
