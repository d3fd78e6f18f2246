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
// The sweep loop they replace costs one full-plane pass per unit of
// component diameter; union-find costs a near-constant number of passes.
// Every union links the smaller root under the larger (atomicCAS(parent
// [small], small, large)), so parents only grow, the forest stays acyclic
// and every tree's root is its largest index; finds halve paths.  The final
// forest does not depend on the order the atomics ran in, only its shape
// does, and the result reads only the roots.
//
// K3, cc_tile_launch (connected_components): one cooperative launch.
// What bounds it on the H100: the bytes, 1 read and 4 written a pixel
// (6.3 us at 2048^2 over 3.35 TB/s); below a few megapixels, one launch's
// latency and the chain of dependent steps inside it.  So the design makes
// one launch, moves little more than those bytes, keeps the unions of a
// tile's interior in shared memory, and keeps each block's chain short:
//   - A persistent grid, at most as many blocks as the card holds at once
//     (occupancy x SMs, looked up once per device), loops over tiles of
//     TILE x TILE pixels of one image (ragged at the right and bottom).
//     TILE is 64, or 32 where 64^2 tiles would leave SMs without one
//     (below ~0.5 Mpx), so a small frame's blocks have 4 pixels a thread.
//   - Phase A, per tile: the mask tile comes in as 4-byte loads (bytes
//     where rows are not whole 4-byte words) into a shared int plane (-1
//     background, else the pixel's tile-local raster index) and into one
//     bit mask a row.  A run of set pixels in a row needs no unions: each of
//     its pixels follows the run's last pixel.  Then one union per pair of
//     runs that touch vertically (for connectivity 2 also diagonally), at
//     the first column where they touch, with shared atomicCAS; run ends
//     then point at their roots, and every pixel at its run end's root.
//     Unions between single pixels would chain a row into a list that
//     every find then walks.
//     Tile-local raster order is global raster order within a tile, so a
//     local root is its local component's largest global index.  The block
//     writes into the output plane, as the parent word -(g) - 1 of the
//     global index g, only the pixels Phase B and C read: the tile's edge
//     pixels (to their local roots) and its local roots (to themselves).
//     The other words stay unwritten until Phase C.
//   - grid.sync().
//   - Phase B, the tile borders only: each set pixel on a tile's top edge
//     unites with its neighbours above (up; up-left and up-right for
//     connectivity 2, also across the corners), each on its left edge with
//     those to the left (left; up-left and down-left).  Global atomicCAS on
//     the parent words, reads through L2 (__ldcg): O(perimeter) atomics.
//   - grid.sync().
//   - Phase C, per tile: the block's local forest again (still in shared
//     memory when the block has one tile, else rebuilt from the mask as in
//     Phase A), one find per local root through the parent words, then
//     every pixel writes its root's global index - image base + 1 (16-byte
//     stores where rows are whole words), and background 0.  A word that
//     another block has already overwritten with its final id (positive)
//     ends a find with that id, which is the whole component's; finds reach
//     only edge pixels and roots, never an unwritten word.
//   The parent plane lives in the output plane, so a call allocates only its
//   output; it reads the mask once (twice when a block rebuilds) and writes
//   each output word once, plus O(perimeter) words.  A tile with no set
//   pixel skips its unions and writes zeros.
//   TILE_THREADS 256, at most 32 registers so that 8 blocks share an SM:
//   1056 blocks on 132 SMs, so 64^2 tiles are one wave up to 2048^2 (1024
//   tiles), and at 4096^2 (4096 tiles) blocks rebuild in Phase C.
//   -Xptxas -v on sm_90a (chip_smoke.py prints it): 32 registers, 16,896
//   bytes of shared memory (64^2) or 4,224 (32^2), a 32- or 16-byte stack.
//   Fully unrolled loops spill at this register cap (a 272-byte stack),
//   hence most loops unroll by 2.
//
// rank_launch (general K4) and ranked_launch build a forest in passes over
// every pixel, on a separate parent plane:
// (1) every foreground pixel is its own root.  (2) every pixel unites with
// its neighbours above and to the left (the 4 of 8-connectivity that come
// earlier in raster order, 2 of 4-connectivity).  (3) each pixel finds its
// root and writes the result.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// K3: cc_tile_kernel, one cooperative launch (see the top of the file).

#define TILE_THREADS 256
#define FULL_MASK 0xffffffffu

// The tile side TILE (32 or 64) fixes the rest: SLICES threads a tile row,
// SLICE_BITS columns each in the bit-mask loops, PX pixels a thread.
template <int TILE>
struct Tiling {
  static constexpr int SLICES = TILE_THREADS / TILE;
  static constexpr int SLICE_BITS = TILE / SLICES;
  static constexpr int PX = TILE * TILE / TILE_THREADS;
};

// the parent word of global index g in the output plane during the kernel
__device__ __forceinline__ int parent_word(int g) { return -g - 1; }

struct CcTile {
  int y0, x0, th, tw;  // first row and column, rows and columns in the image
  int base;            // global index of the image's first pixel
  int first;           // global index of the tile's first pixel
};

template <int TILE>
__device__ __forceinline__ CcTile cc_tile(int t, int H, int W, int tiles_x,
                                          int tiles_per_image) {
  int img = t / tiles_per_image, r = t % tiles_per_image;
  CcTile c;
  c.y0 = (r / tiles_x) * TILE;
  c.x0 = (r % tiles_x) * TILE;
  c.th = min(TILE, H - c.y0);
  c.tw = min(TILE, W - c.x0);
  c.base = img * H * W;
  c.first = c.base + c.y0 * W + c.x0;
  return c;
}

template <int TILE>
__device__ __forceinline__ int tile_global(const CcTile &c, int W, int li) {
  return c.first + li / TILE * W + li % TILE;
}

// this thread's columns of its row in the bit-mask loops
template <int TILE>
__device__ __forceinline__ unsigned long long slice_bits() {
  constexpr int bits = Tiling<TILE>::SLICE_BITS;
  return (bits == 64 ? ~0ull : (1ull << bits) - 1)
         << (bits * (threadIdx.x % Tiling<TILE>::SLICES));
}

// Row ly of the tile as a bit mask (bit x: pixel (ly, x) in the mask); a
// row is TILE / 32 words of rows.
template <int TILE>
__device__ __forceinline__ unsigned long long tile_row(const unsigned *rows,
                                                       int ly) {
  if (TILE == 32) return rows[ly];
  return ((unsigned long long)rows[2 * ly + 1] << 32) | rows[2 * ly];
}

// The last pixel of the run that the foreground pixel li (column lx, row
// bits row) lies in: before the first clear bit from lx on (bits past the
// tile are clear), or at column 63 when every bit from lx on is set
// (~(row >> lx) is then 0).
template <int TILE>
__device__ __forceinline__ int run_end(unsigned long long row, int li,
                                       int lx) {
  unsigned long long clear = ~(row >> lx);
  return li + (clear ? __ffsll(clear) - 2 : TILE - 1 - lx);
}

// shared forest: -1 background, else a parent >= the pixel (a root holds
// itself).  Halving stores only ancestors over a non-root, which no link
// touches, so a plain store is enough.
__device__ __forceinline__ int sfind(volatile int *sp, int x) {
  while (true) {
    int p = sp[x];
    if (p == x) return x;
    int gp = sp[p];
    if (gp != p) sp[x] = gp;
    x = p;
  }
}

__device__ __forceinline__ void sunite(int *sp, int a, int b) {
  while (true) {
    a = sfind(sp, a);
    b = sfind(sp, b);
    if (a == b) return;
    if (a < b) { int t = a; a = b; b = t; }
    if (atomicCAS(sp + b, b, a) == b) return;
  }
}

// The tile into sp (-1 for background, else the pixel's own index) and its
// rows into rows; returns whether any pixel is set.  wide: W % 4 == 0 and
// the mask 4-byte aligned, so 4 pixels a thread come in one load (a group
// of 4 lies wholly inside the tile or wholly outside it), go out in one
// 16-byte shared store, and 8 lanes OR their nibbles into a row word.
template <int TILE>
__device__ __forceinline__ bool load_tile(const uint8_t *mask, int *sp,
                                          unsigned *rows, const CcTile &c,
                                          int W, int wide) {
  constexpr int PX = Tiling<TILE>::PX;
  const int lane = threadIdx.x & 31;
  bool any = false;
  if (wide) {
    unsigned v[PX / 4];  // in registers: both loops unroll fully
#pragma unroll
    for (int k = 0; k < PX / 4; ++k) {
      int li = 4 * (threadIdx.x + k * TILE_THREADS);
      int ly = li / TILE, lx = li % TILE;
      v[k] = ly < c.th && lx < c.tw
                 ? __ldg((const unsigned *)(mask + c.first + ly * W + lx))
                 : 0u;
    }
#pragma unroll
    for (int k = 0; k < PX / 4; ++k) {
      int i = threadIdx.x + k * TILE_THREADS, li = 4 * i;
      unsigned nib = (v[k] & 0xffu ? 1u : 0u) | (v[k] & 0xff00u ? 2u : 0u) |
                     (v[k] & 0xff0000u ? 4u : 0u) |
                     (v[k] & 0xff000000u ? 8u : 0u);
      *(int4 *)(sp + li) =
          make_int4(nib & 1u ? li : -1, nib & 2u ? li + 1 : -1,
                    nib & 4u ? li + 2 : -1, nib & 8u ? li + 3 : -1);
      unsigned word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(FULL_MASK, word, 1);
      word |= __shfl_xor_sync(FULL_MASK, word, 2);
      word |= __shfl_xor_sync(FULL_MASK, word, 4);
      if ((lane & 7) == 0) rows[i / 8] = word;
      any |= nib != 0;
    }
  } else {
    unsigned long long f = 0;  // bit k: the thread's pixel k is set
#pragma unroll 2
    for (int k = 0; k < PX; ++k) {
      int li = threadIdx.x + k * TILE_THREADS, ly = li / TILE, lx = li % TILE;
      if (ly < c.th && lx < c.tw && __ldg(mask + c.first + ly * W + lx) != 0)
        f |= 1ull << k;
    }
#pragma unroll 2
    for (int k = 0; k < PX; ++k) {
      int li = threadIdx.x + k * TILE_THREADS;
      bool set = f >> k & 1u;
      sp[li] = set ? li : -1;
      unsigned b = __ballot_sync(FULL_MASK, set);
      if (lane == 0) rows[li / 32] = b;
    }
    any = f != 0;
  }
  return __syncthreads_or(any);
}

// The tile's local forest in sp (-1 for background), every foreground pixel
// pointing at its local root on return.  Runs of foreground in a row are
// joined without unions: a run's pixels all follow its last pixel.  Then
// one union per pair of runs that touch vertically, at the first column
// where they touch (8-connectivity: also diagonally, where up does not
// join them), between run ends.  In the bit-mask loops thread i takes the
// SLICE_BITS columns of slice i % SLICES of row i / SLICES.  With words,
// also the parent words of the tile's edge pixels and local roots.
// Returns whether any pixel is set.
template <int TILE>
__device__ bool local_forest(const uint8_t *mask, int *sp, unsigned *rows,
                             const CcTile &c, int W, int diag, int wide,
                             int *words) {
  constexpr int PX = Tiling<TILE>::PX;
  volatile int *vsp = sp;
  if (!load_tile<TILE>(mask, sp, rows, c, W, wide)) return false;
  const int ly = threadIdx.x / Tiling<TILE>::SLICES;
  const unsigned long long slice = slice_bits<TILE>();
  const unsigned long long row = tile_row<TILE>(rows, ly);
  if (ly > 0) {
    unsigned long long up = tile_row<TILE>(rows, ly - 1);
    // up: where both are set, unless one column left both are set too
    unsigned long long m_up = row & up & ~((row << 1) & (up << 1)) & slice;
    // up-left (up and left clear) and up-right (up and right clear)
    unsigned long long m_ul = diag ? row & ~up & (up << 1) & ~(row << 1) & slice : 0;
    unsigned long long m_ur = diag ? row & ~up & (up >> 1) & ~(row >> 1) & slice : 0;
    int li0 = ly * TILE;
    for (; m_up; m_up &= m_up - 1) {
      int x = __ffsll(m_up) - 1;
      sunite(sp, run_end<TILE>(row, li0 + x, x), run_end<TILE>(up, li0 - TILE + x, x));
    }
    for (; m_ul; m_ul &= m_ul - 1) {
      int x = __ffsll(m_ul) - 1;
      sunite(sp, run_end<TILE>(row, li0 + x, x),
             run_end<TILE>(up, li0 - TILE + x - 1, x - 1));
    }
    for (; m_ur; m_ur &= m_ur - 1) {
      int x = __ffsll(m_ur) - 1;
      sunite(sp, run_end<TILE>(row, li0 + x, x),
             run_end<TILE>(up, li0 - TILE + x + 1, x + 1));
    }
  }
  __syncthreads();
  // every run end to its root (only owners store: no run end is left short
  // of its root)
  for (unsigned long long ends = row & ~(row >> 1) & slice; ends;
       ends &= ends - 1) {
    int li = ly * TILE + __ffsll(ends) - 1;
    int x = vsp[li];
    while (true) {
      int p = vsp[x];
      if (p == x) break;
      x = p;
    }
    vsp[li] = x;
  }
  __syncthreads();
  // every pixel to its run end's root (a run end's own word is its root
  // already, so no store races a load)
#pragma unroll 2
  for (int k = 0; k < PX; ++k) {
    int li = threadIdx.x + k * TILE_THREADS, pl = li / TILE, lx = li % TILE;
    unsigned long long r = tile_row<TILE>(rows, pl);
    if (!(r >> lx & 1)) continue;
    int root = vsp[run_end<TILE>(r, li, lx)];
    vsp[li] = root;
    if (words && (root == li || pl == 0 || lx == 0 || pl == c.th - 1 ||
                  lx == c.tw - 1))
      words[tile_global<TILE>(c, W, li)] = parent_word(tile_global<TILE>(c, W, root));
  }
  __syncthreads();
  return true;
}

__device__ __forceinline__ int gfind(int *w, int x) {
  while (true) {
    int v = __ldcg(w + x);
    int p = -v - 1;
    if (p == x) return x;
    int v2 = __ldcg(w + p);
    if (-v2 - 1 != p) atomicCAS(w + x, v, v2);
    x = p;
  }
}

__device__ __forceinline__ void gunite(int *w, int a, int b) {
  while (true) {
    a = gfind(w, a);
    b = gfind(w, b);
    if (a == b) return;
    if (a < b) { int t = a; a = b; b = t; }
    if (atomicCAS(w + b, parent_word(b), parent_word(a)) == parent_word(b))
      return;
  }
}

// Phase C's find from a local root: a positive word is a final id (the
// component's); halving only replaces a parent word by another.
__device__ __forceinline__ int gresolve(int *w, int x, int base) {
  while (true) {
    int v = __ldcg(w + x);
    if (v > 0) return v;
    int p = -v - 1;
    if (p == x) return x - base + 1;
    int v2 = __ldcg(w + p);
    if (v2 > 0) return v2;
    if (-v2 - 1 != p) atomicCAS(w + x, v, v2);
    x = p;
  }
}

// a pixel's id from the shared plane after Phase C's finds: -1 background,
// a root's word -(id) - 1, any other pixel's its root
__device__ __forceinline__ int tile_id(const int *sp, int v) {
  return v == -1 ? 0 : -(v >= 0 ? sp[v] : v) - 1;
}

template <int TILE>
__global__ void __launch_bounds__(TILE_THREADS, 8)
    cc_tile_kernel(const uint8_t *mask, int *out, int H, int W, int tiles_x,
                   int tiles_per_image, int n_tiles, int diag, int wide) {
  __shared__ __align__(16) int sp[TILE * TILE];
  __shared__ unsigned rows[TILE * TILE / 32];
  cg::grid_group grid = cg::this_grid();
  const bool rebuild = n_tiles > (int)gridDim.x;

  // Phase A: local forests; parent words of edge pixels and local roots
  bool any = false;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    CcTile c = cc_tile<TILE>(t, H, W, tiles_x, tiles_per_image);
    any = local_forest<TILE>(mask, sp, rows, c, W, diag, wide, out);
  }
  grid.sync();

  // Phase B: unions across the top and left edges of every tile
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    CcTile c = cc_tile<TILE>(t, H, W, tiles_x, tiles_per_image);
    for (int i = threadIdx.x; i < 2 * TILE; i += TILE_THREADS) {
      if (i < TILE) {  // top edge, column x0 + i
        if (c.y0 == 0 || i >= c.tw) continue;
        int y = c.y0, x = c.x0 + i;
        int p = c.base + y * W + x;
        if (!__ldg(mask + p)) continue;
        bool up = __ldg(mask + p - W) != 0;
        if (up) gunite(out, p, p - W);
        if (diag && !up) {
          if (x > 0 && !__ldg(mask + p - 1) && __ldg(mask + p - W - 1))
            gunite(out, p, p - W - 1);
          if (x < W - 1 && !__ldg(mask + p + 1) && __ldg(mask + p - W + 1))
            gunite(out, p, p - W + 1);
        }
      } else {  // left edge, row y0 + i - TILE
        int ly = i - TILE;
        if (c.x0 == 0 || ly >= c.th) continue;
        int y = c.y0 + ly, x = c.x0;
        int p = c.base + y * W + x;
        if (!__ldg(mask + p)) continue;
        bool left = __ldg(mask + p - 1) != 0;
        if (left) gunite(out, p, p - 1);
        if (diag && !left) {
          if (y > 0 && !__ldg(mask + p - W) && __ldg(mask + p - W - 1))
            gunite(out, p, p - W - 1);
          if (y < H - 1 && !__ldg(mask + p + W) && __ldg(mask + p + W - 1))
            gunite(out, p, p + W - 1);
        }
      }
    }
  }
  grid.sync();

  // Phase C: a find per local root (a run end that is a root), then every
  // pixel's id
  constexpr int PX = Tiling<TILE>::PX;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    CcTile c = cc_tile<TILE>(t, H, W, tiles_x, tiles_per_image);
    if (rebuild) any = local_forest<TILE>(mask, sp, rows, c, W, diag, wide, nullptr);
    if (any) {
      const int ly = threadIdx.x / Tiling<TILE>::SLICES;
      unsigned long long row = tile_row<TILE>(rows, ly);
      for (unsigned long long ends = row & ~(row >> 1) & slice_bits<TILE>(); ends;
           ends &= ends - 1) {
        int li = ly * TILE + __ffsll(ends) - 1;
        // a root's shared word becomes -(id) - 1 <= -2
        if (sp[li] == li) sp[li] = -gresolve(out, tile_global<TILE>(c, W, li), c.base) - 1;
      }
      __syncthreads();
    }
    int *o = out + c.first;
    if (wide) {
#pragma unroll 2
      for (int k = 0; k < PX / 4; ++k) {
        int li = 4 * (threadIdx.x + k * TILE_THREADS);
        int ly = li / TILE, lx = li % TILE;
        if (ly >= c.th || lx >= c.tw) continue;
        int4 v = *(const int4 *)(sp + li);
        *(int4 *)(o + ly * W + lx) =
            any ? make_int4(tile_id(sp, v.x), tile_id(sp, v.y),
                            tile_id(sp, v.z), tile_id(sp, v.w))
                : make_int4(0, 0, 0, 0);
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < PX; ++k) {
        int li = threadIdx.x + k * TILE_THREADS, ly = li / TILE, lx = li % TILE;
        if (ly >= c.th || lx >= c.tw) continue;
        o[ly * W + lx] = any ? tile_id(sp, sp[li]) : 0;
      }
    }
    __syncthreads();
  }
}

// The card's SMs and, per tile side, the blocks of cc_tile_kernel it holds
// at once; looked up once per device.
struct CcCard {
  int sms, cap32, cap64;
};

static cudaError_t cc_card(CcCard *card) {
  static CcCard cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev].sms > 0) {
    *card = cache[dev];
    return cudaSuccess;
  }
  CcCard c{};
  int per32 = 0, per64 = 0;
  if ((e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per32, cc_tile_kernel<32>, TILE_THREADS, 0)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per64, cc_tile_kernel<64>, TILE_THREADS, 0)) != cudaSuccess)
    return e;
  if (per32 < 1 || per64 < 1) return cudaErrorCooperativeLaunchTooLarge;
  c.cap32 = c.sms * per32;
  c.cap64 = c.sms * per64;
  if (dev < 64) cache[dev] = c;
  *card = c;
  return cudaSuccess;
}

template <int TILE>
static int cc_tile_run(const void *mask, void *out, int B, int H, int W,
                       int connectivity, int cap, cudaStream_t stream) {
  int tiles_x = (W + TILE - 1) / TILE;
  int tiles_per_image = ((H + TILE - 1) / TILE) * tiles_x;
  int n_tiles = B * tiles_per_image;
  int blocks = n_tiles < cap ? n_tiles : cap;
  int diag = connectivity == 2;
  // 4 pixels a load and a store: rows of whole 4-byte words (out is fresh
  // from the allocator, so aligned)
  int wide = W % 4 == 0 && (uintptr_t)mask % 4 == 0;
  const uint8_t *m = (const uint8_t *)mask;
  int *o = (int *)out;
  void *args[] = {&m, &o, &H, &W, &tiles_x, &tiles_per_image, &n_tiles,
                  &diag, &wide};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void *)cc_tile_kernel<TILE>, dim3(blocks), dim3(TILE_THREADS), args,
      0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// mask (B, H, W) bytes -> out (B, H, W) int32 ids; B * H * W < 2^31.
// Tiles of 64^2, or of 32^2 where 64^2 tiles would leave SMs without one
// (below ~0.5 Mpx: 4 pixels a thread shorten each block's chain of phases;
// once every SM has a tile, smaller tiles only add blocks and borders).
extern "C" int cc_tile_launch(const void *mask, void *out, int B, int H,
                              int W, int connectivity, void *stream) {
  if ((long long)B * H * W == 0) return 0;
  CcCard card;
  cudaError_t e = cc_card(&card);
  if (e != cudaSuccess) return (int)e;
  long long tiles64 = (long long)B * ((H + 63) / 64) * ((W + 63) / 64);
  if (tiles64 < card.sms)
    return cc_tile_run<32>(mask, out, B, H, W, connectivity, card.cap32,
                           (cudaStream_t)stream);
  return cc_tile_run<64>(mask, out, B, H, W, connectivity, card.cap64,
                         (cudaStream_t)stream);
}

__global__ void cc_empty_kernel() {}

// The launch floor: one empty kernel, a plain launch or a cooperative one.
extern "C" int cc_empty_launch(int cooperative, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cooperative) {
    void *args[] = {nullptr};
    cudaError_t e = cudaLaunchCooperativeKernel((void *)cc_empty_kernel,
                                                dim3(1), dim3(1), args, 0, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    cc_empty_kernel<<<1, 1, 0, s>>>();
  }
  return (int)cudaGetLastError();
}
