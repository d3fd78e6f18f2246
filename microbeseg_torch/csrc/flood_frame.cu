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
// A step that changes nothing ends its level early (the next step would be
// the same no-op) and ends the cleanup.  (127 << 24) | 0xFFFFFF equals the
// sentinel, so labels stay below 2^24 - 1.
//
// One kernel, flood_front_kernel (flood_front_launch), one cooperative
// launch per frame; every flood_tiled call launches it.  What
// bounds it on the H100: a chain of ~n_levels * inner_steps + cleanup
// dependent steps, each ended by a barrier over the whole grid, and a step
// changes only the thin front of the basins.  So the fixed cost of a
// barrier-separated step, not bytes, is the limit (the one-block crop
// kernel in flood.cu showed the same), and the design keeps a step to a
// few L2 round trips and one grid barrier:
//   - One block of 1024 threads per SM at most, and no more blocks than
//     1024 words each; block b owns a contiguous range of bitplane words
//     (not of rows, so a frame with fewer rows than blocks works) and is
//     the only writer of those words and of their pixels' keys.
//   - Bitplanes of 32 pixels a word, rows padded to whole words, bits past
//     W zero, in global memory (L2-resident: 512 KB a plane at 2048^2):
//     U, in the mask and unlabelled, in two buffers (a step reads one, the
//     owners write the other); A, active at the level, in two buffers by
//     level parity.  Level lvl reads A[lvl & 1]; during its first step the
//     owners OR the pixels of levels lvl and lvl + 1 into A[(lvl + 1) & 1],
//     which then holds level lvl + 1.  Nothing reads that buffer during
//     level lvl (it held level lvl - 1, whose steps a barrier ended), and
//     the barrier that ends the step orders the writes before level lvl + 1
//     reads them, so the level updates cost no barrier of their own.  The
//     pixels come from a counting sort of each block's in-mask pixels by
//     level in the set-up (histogram in shared memory, scan, scatter into
//     the block's own segment of a list), so each pixel is OR-ed twice.
//   - One key plane (the caller's seeded plane), updated in place.  A
//     labelled pixel's key never changes; a step reads keys only of the
//     pixels S = A & ~U that were labelled and active before it, and writes
//     keys only of its front C = U & A & dilate4(S), so no key that a step
//     reads is written in it.  Each warp lists its front pixels with the
//     directions of their S neighbours in shared memory and spreads the
//     list over its lanes, so a front's key loads are in flight together.
//   - Words, keys and list entries that another SM wrote in this launch are
//     read through L2 (__ldcg): L1 is not coherent across SMs.
//   - The barrier is grid.sync(), and each block ORs whether it changed
//     anything into one of three rotating flag words before it (grid_any).
//     It is not hand-written: the counter barrier tried in its place was
//     no faster, in turns, beyond what separate runs vary (PERF.md).
//
// work_out (optional, zeroed by the caller): per frame, the number of
// candidate pixels the steps examined (in the mask, active at the level,
// still unlabelled), summed over steps: the work the function needs, from
// which a bound on its time is computed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define BIG_KEY 0x7FFFFFFF
#define LABEL_BITS 24
#define LABEL_MASK 0xFFFFFF
#define FULL 0xffffffffu

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

// ---------------------------------------------------------------------------
// flood_front_kernel: see the top of the file.

#define FRONT_THREADS 1024
#define FRONT_WARPS (FRONT_THREADS / 32)
#define FRONT_CAP 64  // front pixels a warp lists before it grows them
#define LEVELS 128    // most levels 24-bit keys leave (7 level bits)
#define BATCH 4       // words a warp loads at once in the set-up passes

// labelled and active before this step: read through L2 (other blocks wrote
// these words)
__device__ __forceinline__ unsigned settled(const unsigned *U,
                                            const unsigned *A, int w) {
  return __ldcg(A + w) & ~__ldcg(U + w);
}

// The front of word w (u = U[w], a = A[w], u & a != 0): its unlabelled
// active pixels next to a settled one.  m[0..3]: per bit, whether the pixel
// above, below, left, right is settled; *base: the word's first pixel.
__device__ __forceinline__ unsigned front_word(const unsigned *U,
                                               const unsigned *A, int w,
                                               unsigned u, unsigned a, int H,
                                               int W, int wpr, unsigned m[4],
                                               int *base) {
  const int r = w / wpr, j = w - r * wpr;
  const unsigned s = a & ~u;
  const unsigned sl = j > 0 ? settled(U, A, w - 1) : 0u;
  const unsigned sr = j < wpr - 1 ? settled(U, A, w + 1) : 0u;
  m[0] = r > 0 ? settled(U, A, w - wpr) : 0u;
  m[1] = r < H - 1 ? settled(U, A, w + wpr) : 0u;
  m[2] = (s << 1) | (sl >> 31);
  m[3] = (s >> 1) | (sr << 31);
  *base = r * W + (j << 5);
  return u & a & (m[0] | m[1] | m[2] | m[3]);
}

__device__ __forceinline__ int dirs_of(const unsigned m[4], int bit) {
  return ((m[0] >> bit) & 1u) | (((m[1] >> bit) & 1u) << 1) |
         (((m[2] >> bit) & 1u) << 2) | (((m[3] >> bit) & 1u) << 3);
}

// the new key of list entry e = {pixel, directions of its settled
// neighbours}: the smallest of their keys, re-keyed at the pixel's level
__device__ __forceinline__ int front_key(const int *qs, const int *key,
                                         int2 e, int W) {
  const int p = e.x, d = e.y;
  const int q = __ldg(qs + p);
  unsigned best = BIG_KEY;
  if (d & 1) best = min(best, (unsigned)__ldcg(key + p - W));
  if (d & 2) best = min(best, (unsigned)__ldcg(key + p + W));
  if (d & 4) best = min(best, (unsigned)__ldcg(key + p - 1));
  if (d & 8) best = min(best, (unsigned)__ldcg(key + p + 1));
  return q | ((int)best & LABEL_MASK);
}

// writes a grown key.  A key equal to BIG_KEY (level 127 with label
// 2^24 - 1) reads as unlabelled, as in the plain version: the pixel stays
// in U (its word is this block's, and its lane stored Un before the
// __syncwarp that precedes the growing).
__device__ __forceinline__ void put_front_key(int *key, unsigned *Un, int p,
                                              int k, int W, int wpr) {
  if (k != BIG_KEY) {
    __stcg(key + p, k);
  } else {
    const int r = p / W, c = p - r * W;
    atomicOr(Un + r * wpr + (c >> 5), 1u << (c & 31));
  }
}

// grows the n <= 2 * 32 front pixels of a warp's list: each lane takes two
// and issues the loads of both before either store
__device__ __forceinline__ void grow_front(const int *qs, int *key,
                                           unsigned *Un, const int2 *list,
                                           int n, int lane, int W, int wpr) {
  const bool ha = lane < n, hb = lane + 32 < n;
  int2 ea = make_int2(0, 0), eb = make_int2(0, 0);
  if (ha) ea = list[lane];
  if (hb) eb = list[lane + 32];
  int ka = 0, kb = 0;
  if (ha) ka = front_key(qs, key, ea, W);
  if (hb) kb = front_key(qs, key, eb, W);
  if (ha) put_front_key(key, Un, ea.x, ka, W, wpr);
  if (hb) put_front_key(key, Un, eb.x, kb, W, wpr);
}

__global__ void __launch_bounds__(FRONT_THREADS, 1)
flood_front_kernel(const int *__restrict__ qs, int *key,
                   int *__restrict__ out, unsigned *planes, int *list,
                   int *flags, int *__restrict__ steps_out,
                   unsigned long long *__restrict__ work_out, int H, int W,
                   int n_levels, int inner_steps, int max_final_iters) {
  __shared__ int start[LEVELS + 1];  // counts, then each level's start
  __shared__ int cursor[LEVELS];
  __shared__ int2 s_front[FRONT_WARPS * FRONT_CAP];
  __shared__ int s_any;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpr = (W + 31) >> 5;  // words per row
  const int nw = H * wpr;
  const int wb = (int)((long long)blockIdx.x * nw / gridDim.x);
  const int we = (int)((long long)(blockIdx.x + 1) * nw / gridDim.x);
  unsigned *U = planes, *Un = planes + nw;
  unsigned *A0 = planes + 2 * (size_t)nw, *A1 = planes + 3 * (size_t)nw;
  int *seg = list + (size_t)wb * 32;  // room for every pixel of the range
  int2 *flist = s_front + warp * FRONT_CAP;
  int nbar = 0;

  auto barrier = [&](int changed) {
    return grid_any(grid, changed, flags, &s_any, nbar++);
  };

  // ---- set-up: U, A at level 0, and the level histogram; a warp per word,
  // a lane per pixel, BATCH words at a time, their loads first ----
  for (int l = tid; l <= LEVELS; l += FRONT_THREADS) start[l] = 0;
  __syncthreads();
  for (int w0 = wb + warp; w0 < we; w0 += BATCH * FRONT_WARPS) {
    int a[BATCH], k[BATCH];
    bool inside[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int wi = min(w0 + i * FRONT_WARPS, we - 1);
      const int r = wi / wpr, c = ((wi - r * wpr) << 5) + lane;
      const int p = r * W + min(c, W - 1);
      inside[i] = c < W;
      a[i] = __ldg(qs + p);
      k[i] = key[p];
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int wi = w0 + i * FRONT_WARPS;
      if (wi >= we) break;  // the same in every lane
      const bool in = inside[i] && a[i] != BIG_KEY;
      const int q = in ? (a[i] >> LABEL_BITS) : -1;
      const unsigned u = __ballot_sync(FULL, in && k[i] == BIG_KEY);
      const unsigned a0 = __ballot_sync(FULL, q == 0);
      if (lane == 0) {
        U[wi] = u;
        A0[wi] = a0;
        A1[wi] = 0u;
      }
      if (q >= 0) atomicAdd(start + q, 1);
    }
  }
  __syncthreads();
  // exclusive scan of the counts: one warp, LEVELS / 32 levels a lane
  if (warp == 0) {
    const int per = LEVELS / 32, i0 = lane * per;
    int sum = 0;
    for (int i = i0; i < i0 + per; ++i) sum += start[i];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    int run = incl - sum;
    for (int i = i0; i < i0 + per; ++i) {
      const int cnt = start[i];
      start[i] = run;
      cursor[i] = run;
      run += cnt;
    }
    if (lane == 31) start[LEVELS] = incl;
  }
  __syncthreads();
  // scatter: the padded index (word << 5 | bit) of every in-mask pixel of
  // the range, sorted by level
  for (int w0 = wb + warp; w0 < we; w0 += BATCH * FRONT_WARPS) {
    int a[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int wi = min(w0 + i * FRONT_WARPS, we - 1);
      const int r = wi / wpr, c = ((wi - r * wpr) << 5) + lane;
      a[i] = c < W ? __ldg(qs + r * W + c) : BIG_KEY;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int wi = w0 + i * FRONT_WARPS;
      if (wi < we && a[i] != BIG_KEY)
        seg[atomicAdd(cursor + (a[i] >> LABEL_BITS), 1)] = (wi << 5) | lane;
    }
  }
  barrier(0);  // every block's words before any step reads its neighbours

  // ---- the steps ----
  long long examined = 0;
  auto step = [&](const unsigned *A) {
    unsigned changed = 0;
    int filled = 0;  // entries in the warp's list (the same in every lane)
    // thread tid owns words wb + tid, wb + tid + FRONT_THREADS, ...: two at
    // a time, the loads of both first
    for (int w2 = wb + (warp << 5); w2 < we; w2 += 2 * FRONT_THREADS) {
      const int w0 = w2 + lane, w1 = w0 + FRONT_THREADS;
      unsigned u0 = 0, a0 = 0, u1 = 0, a1 = 0;
      if (w0 < we) {
        u0 = __ldcg(U + w0);
        a0 = __ldcg(A + w0);
      }
      if (w1 < we) {
        u1 = __ldcg(U + w1);
        a1 = __ldcg(A + w1);
      }
      unsigned m0[4], m1[4], c0 = 0, c1 = 0;
      int base0 = 0, base1 = 0;
      if (u0 & a0) {
        c0 = front_word(U, A, w0, u0, a0, H, W, wpr, m0, &base0);
        examined += __popc(u0 & a0);
      }
      if (u1 & a1) {
        c1 = front_word(U, A, w1, u1, a1, H, W, wpr, m1, &base1);
        examined += __popc(u1 & a1);
      }
      if (w0 < we) __stcg(Un + w0, u0 & ~c0);
      if (w1 < we) __stcg(Un + w1, u1 & ~c1);
      changed |= c0 | c1;
      if (__any_sync(FULL, c0 | c1)) {
        // list the front pixels, lane by lane (each lane's of w0, then of
        // w1); grow the list whenever it is full
        const int n = __popc(c0) + __popc(c1);
        int incl = n;
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += t;
        }
        const int excl = incl - n;
        const int total = __shfl_sync(FULL, incl, 31);
        unsigned rest0 = c0, rest1 = c1;
        for (int done = 0; done < total;) {
          const int take = min(FRONT_CAP - filled, total - done);
          const int i1 = min(done + take - excl, n);
          for (int i = max(done - excl, 0); i < i1; ++i) {
            const bool first = rest0 != 0;
            const int bit = __ffs(first ? rest0 : rest1) - 1;
            flist[filled + excl + i - done] =
                first ? make_int2(base0 + bit, dirs_of(m0, bit))
                      : make_int2(base1 + bit, dirs_of(m1, bit));
            if (first)
              rest0 &= rest0 - 1;
            else
              rest1 &= rest1 - 1;
          }
          filled += take;
          done += take;
          if (filled == FRONT_CAP) {
            __syncwarp();  // the list and Un stored before they are read
            grow_front(qs, key, Un, flist, filled, lane, W, wpr);
            __syncwarp();
            filled = 0;
          }
        }
      }
    }
    if (filled) {
      __syncwarp();
      grow_front(qs, key, Un, flist, filled, lane, W, wpr);
    }
    const int any = barrier(changed != 0);
    unsigned *t = U;
    U = Un;
    Un = t;
    return any;
  };

  int nsteps = 0;
  // this thread's first pixel of the next level update, loaded a level
  // ahead
  int next = tid < start[min(2, LEVELS)] ? seg[tid] : 0;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const unsigned *A = (lvl & 1) ? A1 : A0;
    for (int s = 0; s < inner_steps; ++s) {
      if (s == 0) {
        // A[(lvl + 1) & 1], which held level lvl - 1, takes levels lvl and
        // lvl + 1 of this block's pixels
        unsigned *An = (lvl & 1) ? A0 : A1;
        const int s0 = start[lvl], e = start[min(lvl + 2, LEVELS)];
        if (s0 + tid < e) atomicOr(An + (next >> 5), 1u << (next & 31));
        for (int i = s0 + tid + FRONT_THREADS; i < e; i += FRONT_THREADS) {
          const int pp = seg[i];
          atomicOr(An + (pp >> 5), 1u << (pp & 31));
        }
        const int s1 = start[lvl + 1], e1 = start[min(lvl + 3, LEVELS)];
        if (s1 + tid < e1) next = seg[s1 + tid];
      }
      const int any = step(A);
      ++nsteps;
      if (!any) break;
    }
  }
  // every in-mask pixel is active at the last level
  const unsigned *A_all = ((n_levels - 1) & 1) ? A1 : A0;
  for (int it = 0; it < max_final_iters; ++it) {
    const int any = step(A_all);
    ++nsteps;
    if (!any) break;
  }

  // ---- labels of this block's pixels ----
  for (int wi = wb + warp; wi < we; wi += FRONT_WARPS) {
    const int r = wi / wpr, c = ((wi - r * wpr) << 5) + lane;
    if (c < W) {
      const int k = __ldcg(key + r * W + c);
      out[r * W + c] = k < BIG_KEY ? (k & LABEL_MASK) : 0;
    }
  }
  if (blockIdx.x == 0 && tid == 0) *steps_out = nsteps;
  if (work_out) {
    for (int o = 16; o > 0; o >>= 1)
      examined += __shfl_xor_sync(FULL, examined, o);
    if (lane == 0 && examined)
      atomicAdd(work_out, (unsigned long long)examined);
  }
}

// qs, key (the seeded plane; updated in place), out: (B, H, W) int32;
// planes: 4 * H * ceil(W / 32) uint32 and list: 32 * H * ceil(W / 32)
// int32, scratch reused frame after frame; flags: (B, 3) int32 zeros;
// steps: (B,) int32; work: (B,) int64 or null.
extern "C" int flood_front_launch(const void *qs, void *key, void *out,
                                  void *planes, void *list, void *flags,
                                  void *steps, void *work, int B, int H,
                                  int W, int n_levels, int inner_steps,
                                  int max_final_iters, void *stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flood_front_kernel, FRONT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long n = (long long)H * W;
  if (n == 0 || B == 0) return 0;
  if (n_levels > LEVELS) return (int)cudaErrorInvalidValue;
  // one block per SM at most, and no block with fewer than 1024 words
  // unless the frame has fewer
  const long long nw = (long long)H * ((W + 31) / 32);
  const long long want = (nw + FRONT_THREADS - 1) / FRONT_THREADS;
  int blocks = (int)(want < sms ? want : sms);
  for (int b = 0; b < B; ++b) {
    const int *qs_b = (const int *)qs + b * n;
    int *key_b = (int *)key + b * n;
    int *out_b = (int *)out + b * n;
    int *flags_b = (int *)flags + b * 3;
    int *steps_b = (int *)steps + b;
    unsigned long long *work_b =
        work ? (unsigned long long *)work + b : nullptr;
    void *args[] = {&qs_b,    &key_b, &out_b,  &planes,   &list,
                    &flags_b, &steps_b, &work_b, &H,      &W,
                    &n_levels, &inner_steps, &max_final_iters};
    e = cudaLaunchCooperativeKernel((void *)flood_front_kernel, dim3(blocks),
                                    dim3(FRONT_THREADS), args, 0,
                                    (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
