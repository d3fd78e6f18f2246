// Whole-frame packed-key marker flood with 24 label bits, for frames with a
// side above 768.
//
// Replaces the TPU kernel microbeseg_tpu/ops/pallas/flood.py::_flood_packed
// (_packed_flood_kernel), which flood_tiled runs on (512 + 2 * 64)^2 windows
// of the frame and follows with a sweep loop for basins that reach beyond a
// window's halo.  Same kernel body, on one window that covers the frame: the
// caller hands in two int32 planes, qs = level << 24 inside the mask and the
// sentinel 0x7FFFFFFF outside it, and key = qs | label at the seeds and the
// sentinel elsewhere.  Each level runs inner_steps synchronous 4-neighbour
// key-min steps over qs <= level << 24 (a grown pixel re-keys at its own
// level), then steps over the whole mask run to the fixed point.  With one
// window there is no halo, so nothing is left for a sweep loop afterwards.
//
// What bounds it on the H100: a chain of ~n_levels * inner_steps + cleanup
// dependent sweeps over the frame, a few integer operations per pixel, with
// a barrier over the whole grid between steps.  At 2048^2 the three int32
// planes are 48 MB, the size of the L2, so each step streams the key plane
// in and out of device memory: bytes per step and the barrier's latency,
// not arithmetic, are the limit.
//
// Design: one cooperative launch per frame with as many blocks as the card
// holds at once (from the occupancy calculator), so grid.sync() can order
// the steps and no step needs a host round trip or a launch of its own.
// Threads stride over the pixels in linear order, so loads and stores
// coalesce.  Every step reads the old key plane and writes the new one
// (ping-pong): an in-place update would let labels travel further within a
// level's steps and change the result.  Keys that another block wrote are
// read through L2 (__ldcg).  A step that changes nothing ends its level
// early (the next step would be the same no-op) and ends the cleanup; the
// grid-wide "changed" flag is one of three rotating words in device memory.
// Keys of labelled neighbours carry their own level, so "neighbour is
// active" is "neighbour key < (level + 1) << 24", and the level plane is
// read only at pixels that are still unlabelled.  (127 << 24) | 0xFFFFFF
// equals the sentinel, so labels stay below 2^24 - 1, and (level + 1) << 24
// is clamped to the sentinel at level 127, where it would overflow.
//
// work_out (optional, zeroed by the caller): per frame, the number of
// candidate pixels the steps examined (in the mask, active at the level,
// still unlabelled), summed over steps: the work the function needs, from
// which a bound on its time is computed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 512
#define BIG_KEY 0x7FFFFFFF
#define LABEL_BITS 24
#define LABEL_MASK 0xFFFFFF

__device__ __forceinline__ int grid_any(cg::grid_group &grid, int changed,
                                        int *flags, int *s_any, int step) {
  // flags: 3 rotating words.  Word step % 3 is OR-ed this step; block 0
  // clears word (step + 1) % 3, last read two steps ago, before this
  // step's barrier.
  int slot = step % 3;
  int block_changed = __syncthreads_or(changed);
  if (threadIdx.x == 0) {
    if (block_changed) atomicOr(flags + slot, 1);
    if (blockIdx.x == 0) atomicExch(flags + (slot + 1) % 3, 0);
  }
  grid.sync();
  if (threadIdx.x == 0) *s_any = __ldcg(flags + slot);
  __syncthreads();
  return *s_any;
}

__global__ void __launch_bounds__(THREADS)
flood_frame_kernel(const int *__restrict__ qs, int *key_a, int *key_b,
                   int *__restrict__ out, int *flags,
                   int *__restrict__ steps_out,
                   unsigned long long *__restrict__ work_out, int H, int W,
                   int n_levels, int inner_steps, int max_final_iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_any;
  const int n = H * W;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  int *cur = key_a, *nxt = key_b;

  // one synchronous step: returns whether this thread grew a pixel.
  // active(p): qs[p] <= athr; a labelled neighbour counts iff key < thr.
  long long examined = 0;
  auto step = [&](const int *src, int *dst, int athr, unsigned thr) {
    int changed = 0;
    for (int p = first; p < n; p += stride) {
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
            k = a | ((int)best & LABEL_MASK);
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
    long long t = ((long long)(lvl + 1)) << LABEL_BITS;
    unsigned thr = t < BIG_KEY ? (unsigned)t : (unsigned)BIG_KEY;
    int athr = lvl << LABEL_BITS;
    for (int s = 0; s < inner_steps; ++s) {
      int changed = step(cur, nxt, athr, thr);
      int any = grid_any(grid, changed, flags, &s_any, nsteps);
      int *tmp = cur; cur = nxt; nxt = tmp;
      ++nsteps;
      if (!any) break;
    }
  }
  for (int it = 0; it < max_final_iters; ++it) {
    int changed = step(cur, nxt, BIG_KEY - 1, (unsigned)BIG_KEY);
    int any = grid_any(grid, changed, flags, &s_any, nsteps);
    int *tmp = cur; cur = nxt; nxt = tmp;
    ++nsteps;
    if (!any) break;
  }

  for (int p = first; p < n; p += stride) {
    int k = __ldcg(cur + p);
    out[p] = k < BIG_KEY ? (k & LABEL_MASK) : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *steps_out = nsteps;
  if (work_out) {
    for (int o = 16; o > 0; o >>= 1)
      examined += __shfl_xor_sync(0xffffffff, examined, o);
    if ((threadIdx.x & 31) == 0 && examined)
      atomicAdd(work_out, (unsigned long long)examined);
  }
}

// qs, key (the seeded plane; overwritten), scratch, out: (B, H, W) int32;
// flags: (B, 3) int32 zeros; steps: (B,) int32; work: (B,) int64 or null.
extern "C" int flood_frame_launch(const void *qs, void *key, void *scratch,
                                  void *out, void *flags, void *steps,
                                  void *work, int B, int H, int W,
                                  int n_levels, int inner_steps,
                                  int max_final_iters, void *stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flood_frame_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long n = (long long)H * W;
  if (n == 0 || B == 0) return 0;
  long long want = (n + THREADS - 1) / THREADS;
  long long fit = (long long)sms * per_sm;
  int blocks = (int)(want < fit ? want : fit);
  for (int b = 0; b < B; ++b) {
    const int *qs_b = (const int *)qs + b * n;
    int *key_b = (int *)key + b * n;
    int *scratch_b = (int *)scratch + b * n;
    int *out_b = (int *)out + b * n;
    int *flags_b = (int *)flags + b * 3;
    int *steps_b = (int *)steps + b;
    unsigned long long *work_b =
        work ? (unsigned long long *)work + b : nullptr;
    void *args[] = {&qs_b, &key_b, &scratch_b, &out_b, &flags_b, &steps_b,
                    &work_b, &H, &W, &n_levels, &inner_steps,
                    &max_final_iters};
    e = cudaLaunchCooperativeKernel((void *)flood_frame_kernel, dim3(blocks),
                                    dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
