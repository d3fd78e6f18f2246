// Packed-key marker flood (batched marker watershed), one launch per batch.
//
// Replaces the TPU kernel microbeseg_tpu/ops/pallas/flood.py::flood_pallas
// (_flood_kernel).  Same function: per image, quantise the in-mask value to
// n_levels levels with the image's own min and max (the same float32
// operations: subtract, divide, multiply, truncate, clip), key every pixel
// as (q << label_bits) | label, run inner_steps synchronous 4-neighbour
// key-min steps per level over mask & q <= level (a grown pixel re-keys at
// its own level), then full-mask steps to a fixed point.
//
// What bounds it on the H100: the ~n_levels * inner_steps + cleanup steps
// are a chain of dependent sweeps over the image, each a few integer
// operations per pixel, with a barrier between steps.  The data is small
// (a 256^2 int32 plane is 256 KB), so latency of the step chain, not DRAM
// bandwidth, is the limit.
//
// Design: one thread-block cluster of CLUSTER blocks per image; each block
// owns a band of rows.  The key planes live in global memory and stay in
// L2 (16 images x 3 planes x 256 KB = 12 MB); a 256 KB plane does not fit
// one block's 227 KB of shared memory, and sides up to 768 must work.
// Every step reads the old plane and writes the new one (ping-pong): an
// in-place update would let labels travel further within a level's steps
// and change the result.  Loads that may see another block's writes go
// through L2 (__ldcg); cluster.sync() orders the steps.  A step that
// changes nothing ends its level early (the next step would be the same
// no-op), and the cleanup stops at its fixed point; the cluster-wide
// "changed" flag lives in block 0's shared memory, so no step needs a host
// round trip.  Keys of labelled neighbours carry their own level, so
// "neighbour is active" is "neighbour key < (level + 1) << label_bits"
// and no level plane of the neighbours is read.
//
// work_out (optional, zeroed by the caller): per image, the number of
// candidate pixels the steps examined (in the mask, active at the level,
// still unlabelled), summed over steps: the work the function needs, from
// which a bound on its time is computed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CLUSTER 8
#define THREADS 512
#define BIG_KEY 0x7FFFFFFF
#define BIG_F 3.0e38f

__device__ __forceinline__ int cluster_any(cg::cluster_group &cluster,
                                           int changed, int *flags,
                                           int *s_any, int step) {
  // flags: 3 rotating slots in block 0's shared memory.  Slot step % 3 is
  // OR-ed this step; block 0 clears slot (step + 1) % 3, last read two
  // steps ago, before this step's barrier.
  int slot = step % 3;
  int block_changed = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    int *f0 = cluster.map_shared_rank(flags, 0);
    if (block_changed) atomicOr(f0 + slot, 1);
    if (cluster.block_rank() == 0) flags[(slot + 1) % 3] = 0;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    volatile int *f0 = cluster.map_shared_rank(flags, 0);
    *s_any = f0[slot];
  }
  __syncthreads();
  return *s_any;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
flood_kernel(const float *__restrict__ value, const int *__restrict__ markers,
             const uint8_t *__restrict__ mask, int *__restrict__ out,
             int *__restrict__ qs_plane, int *key_a, int *key_b,
             int *__restrict__ steps_out,
             unsigned long long *__restrict__ work_out, int H, int W,
             int n_levels,
             int inner_steps, int label_bits, int max_final_iters) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float s_red[2][THREADS / 32];
  __shared__ float s_part[2];
  __shared__ int flags[3];
  __shared__ int s_any;
  __shared__ float s_span[2];

  const int rank = cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const size_t base = (size_t)b * H * W;
  const int rows = (H + CLUSTER - 1) / CLUSTER;
  const int r0 = min(H, rank * rows), r1 = min(H, r0 + rows);
  const int p0 = r0 * W, p1 = r1 * W;
  const int lmask = (1 << label_bits) - 1;
  const float *v = value + base;
  const int *mk = markers + base;
  const uint8_t *m = mask + base;
  int *qs = qs_plane + base;
  int *cur = key_a + base, *nxt = key_b + base;

  // ---- per-image min / max over the mask (cluster reduction) ----
  float lo = BIG_F, hi = -BIG_F;
  for (int p = p0 + threadIdx.x; p < p1; p += THREADS) {
    if (m[p]) {
      lo = fminf(lo, v[p]);
      hi = fmaxf(hi, v[p]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffff, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffff, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_red[0][threadIdx.x >> 5] = lo;
    s_red[1][threadIdx.x >> 5] = hi;
  }
  if (threadIdx.x < 3) flags[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < THREADS / 32; ++i) {
      lo = fminf(lo, s_red[0][i]);
      hi = fmaxf(hi, s_red[1][i]);
    }
    s_part[0] = lo;
    s_part[1] = hi;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    for (int r = 0; r < CLUSTER; ++r) {
      float *part = cluster.map_shared_rank(s_part, r);
      lo = fminf(lo, part[0]);
      hi = fmaxf(hi, part[1]);
    }
    s_span[0] = lo;
    s_span[1] = fmaxf(__fsub_rn(hi, lo), 1e-20f);
  }
  __syncthreads();
  const float vmin = s_span[0], span = s_span[1];
  const float scale = (float)(n_levels - 1);

  // ---- level planes and seeded keys (own band only) ----
  for (int p = p0 + threadIdx.x; p < p1; p += THREADS) {
    int a = BIG_KEY;
    if (m[p]) {
      float t = __fmul_rn(__fdiv_rn(__fsub_rn(v[p], vmin), span), scale);
      int q = (int)t;  // truncation toward zero, like astype(int32)
      q = min(max(q, 0), n_levels - 1);
      a = q << label_bits;
    }
    qs[p] = a;
    int mkv = mk[p];
    cur[p] = (a != BIG_KEY && mkv > 0) ? (a | mkv) : BIG_KEY;
  }
  cluster.sync();

  // one synchronous step: returns whether this thread grew a pixel.
  // active(p): qs[p] <= athr; a labelled neighbour counts iff key < thr.
  long long examined = 0;
  auto step = [&](const int *src, int *dst, int athr, unsigned thr) {
    int changed = 0;
    for (int p = p0 + threadIdx.x; p < p1; p += THREADS) {
      int k = __ldcg(src + p);
      if (k == BIG_KEY) {
        int a = qs[p];
        if (a <= athr) {
          ++examined;
          int r = p / W, c = p - r * W;
          unsigned best = BIG_KEY;
          if (r > 0) best = min(best, (unsigned)__ldcg(src + p - W));
          if (r < H - 1) best = min(best, (unsigned)__ldcg(src + p + W));
          if (c > 0) best = min(best, (unsigned)__ldcg(src + p - 1));
          if (c < W - 1) best = min(best, (unsigned)__ldcg(src + p + 1));
          if (best < thr) {
            k = a | ((int)best & lmask);
            changed = 1;
          }
        }
      }
      __stcg(dst + p, k);
    }
    return changed;
  };

  int nsteps = 0;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    long long t = ((long long)(lvl + 1)) << label_bits;
    unsigned thr = t < BIG_KEY ? (unsigned)t : (unsigned)BIG_KEY;
    int athr = lvl << label_bits;
    for (int s = 0; s < inner_steps; ++s) {
      int changed = step(cur, nxt, athr, thr);
      int any = cluster_any(cluster, changed, flags, &s_any, nsteps);
      int *tmp = cur; cur = nxt; nxt = tmp;
      ++nsteps;
      if (!any) break;
    }
  }
  for (int it = 0; it < max_final_iters; ++it) {
    int changed = step(cur, nxt, BIG_KEY - 1, (unsigned)BIG_KEY);
    int any = cluster_any(cluster, changed, flags, &s_any, nsteps);
    int *tmp = cur; cur = nxt; nxt = tmp;
    ++nsteps;
    if (!any) break;
  }

  for (int p = p0 + threadIdx.x; p < p1; p += THREADS) {
    int k = __ldcg(cur + p);
    out[base + p] = k < BIG_KEY ? (k & lmask) : 0;
  }
  if (rank == 0 && threadIdx.x == 0) steps_out[b] = nsteps;
  if (work_out) {
    for (int o = 16; o > 0; o >>= 1)
      examined += __shfl_xor_sync(0xffffffff, examined, o);
    if ((threadIdx.x & 31) == 0 && examined)
      atomicAdd(work_out + b, (unsigned long long)examined);
  }
  // no block may exit while another can still read its shared memory
  cluster.sync();
}

extern "C" int flood_packed_launch(const void *value, const void *markers,
                                   const void *mask, void *out, void *qs,
                                   void *key_a, void *key_b, void *steps,
                                   void *work, int B, int H, int W,
                                   int n_levels, int inner_steps,
                                   int label_bits,
                                   int max_final_iters, void *stream) {
  flood_kernel<<<B * CLUSTER, THREADS, 0, (cudaStream_t)stream>>>(
      (const float *)value, (const int *)markers, (const uint8_t *)mask,
      (int *)out, (int *)qs, (int *)key_a, (int *)key_b, (int *)steps,
      (unsigned long long *)work, H, W,
      n_levels, inner_steps, label_bits, max_final_iters);
  return (int)cudaGetLastError();
}
