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
// are a chain of dependent steps with a barrier between them, and a step
// changes only the few dozen pixels of the front.  The data is small (a
// 256^2 int32 plane is 256 KB), so the latency of the step chain, not DRAM
// bandwidth, is the limit.
//
// Two kernels, picked by the wrapper's shape rule (ops/kernels/flood.py):
// flood_block_kernel, one block per image, for n_levels <= 256 (every
// caller in the package), and flood_kernel, an 8-block cluster per image,
// for any n_levels the packed key takes.  Both give the same labels, the
// same step counts and the same work counts.
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
#define BLOCK_THREADS 1024
#define BIG_KEY 0x7FFFFFFF
#define BIG_F 3.0e38f
#define FULL 0xffffffffu
#define FRONT_CAP 64  // front pixels a warp lists before it grows them
#define BATCH 4       // words a warp loads at once in the set-up passes

// ---------------------------------------------------------------------------
// The cluster kernel: one thread-block cluster of CLUSTER blocks per image;
// each block owns a band of rows.  The key planes live in global memory and
// stay in L2 (16 images x 3 planes x 256 KB = 12 MB).  Every step sweeps
// the band, reads the old plane and writes the new one (ping-pong, since a
// step reads every neighbour's key and an in-place update would let labels
// travel further within a step).  Loads that may see another block's
// writes go through L2 (__ldcg); cluster.sync() orders the steps.  A step
// that changes nothing ends its level early (the next step would be the
// same no-op), and the cleanup stops at its fixed point; the cluster-wide
// "changed" flag lives in block 0's shared memory, so no step needs a host
// round trip.  Keys of labelled neighbours carry their own level, so
// "neighbour is active" is "neighbour key < (level + 1) << label_bits" and
// no level plane of the neighbours is read.

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

// ---------------------------------------------------------------------------
// The block kernel: one block of BLOCK_THREADS threads per image, no
// cluster.  The state a step reads sits in the block's shared memory as
// bitplanes of 32 pixels a word (rows padded to whole words; bits past W
// are 0):
//   U  in the mask and still unlabelled, in two buffers: a step reads one
//      and writes the other, so one barrier ends a step;
//   A  active at the current level (mask & q <= level); after the last
//      level it equals the mask, which the cleanup steps need.
// At 768^2, the largest side the wrapper sends here, the three planes take
// 216 KB of the 227 KB a block may have, the front lists below 8 KB.
//
// The keys stay in one int32 plane in global memory (L2), updated in place.
// A labelled pixel's key never changes; a step reads keys only of the
// pixels S = A & ~U that were labelled and active before it, and writes
// keys only of its front C = U & A & dilate4(S), so no key that a step
// reads is written in it, and it still sees only the old labels.  The slot
// of an unlabelled in-mask pixel holds its own level key q << label_bits,
// which it keeps when it grows; outside the mask the slot holds BIG_KEY.
// Keys written in this launch are read with plain loads after a barrier
// (no __ldg: the read-only path does not see them).
//
// A step is word-parallel.  A thread owns words tid, tid + BLOCK_THREADS,
// ... and takes them two at a time, the loads of both first.  A word with
// no unlabelled active pixel (most of them) only copies U to Un; the others
// compute C from the word and its four neighbours' words.  Each warp lists
// its front pixels in shared memory (one prefix sum of the lanes' counts
// for both words places them) and spreads the list over its lanes, two
// pixels a lane, which read the neighbour keys where S is set and write the
// new keys: up to 64 front pixels a warp cost one round trip to L2, and a
// dense front does not serialise one thread's loads.
// __syncthreads_or(C != 0) is the step's "changed" flag and its only
// barrier.  A grows level by level from a counting sort of the in-mask
// pixels by level (histogram with shared atomics, a scan, a scatter into
// `order`, read a level ahead), so each pixel is OR-ed into A once.  Steps,
// early exits, the cleanup to the fixed point and the work count (popcount
// of U & A per step) are those of the cluster kernel.
//
// What bounds it: the chain of steps, each ended by the block's barrier,
// about half of whose time is the fixed cost of a step (the steps of an
// empty mask cost it too); then the set-up, bound by the instructions it
// issues on its image's one SM (chip_smoke.py times the parts).

// w / d for the word indices of one image (w < 2^15, d <= 24) as a multiply
// by magic = ceil(2^32 / d): exact there, and a few instructions where an
// integer division by a variable takes some twenty
__device__ __forceinline__ int div_rows(int w, unsigned long long magic) {
  return (int)(((unsigned long long)w * magic) >> 32);
}

__device__ __forceinline__ unsigned labelled_active(const unsigned *U,
                                                    const unsigned *A,
                                                    int w) {
  return A[w] & ~U[w];
}

// the new key of the front pixel pp = (word << 5) | bit: the key of its
// labelled active neighbour with the smallest key, re-keyed at its own level
// (its slot holds its level key).  Loads only; *p receives its pixel index.
__device__ __forceinline__ int new_key(const int *key, const unsigned *U,
                                       const unsigned *A, int pp, int H,
                                       int W, int wpr,
                                       unsigned long long magic, int lmask,
                                       int *p) {
  const int w = pp >> 5, bit = pp & 31;
  const int r = div_rows(w, magic), j = w - r * wpr;
  *p = r * W + (j << 5) + bit;
  const unsigned s = labelled_active(U, A, w);
  const bool up = r > 0 && ((labelled_active(U, A, w - wpr) >> bit) & 1u);
  const bool down =
      r < H - 1 && ((labelled_active(U, A, w + wpr) >> bit) & 1u);
  const bool left = bit > 0 ? ((s >> (bit - 1)) & 1u)
                            : (j > 0 && (labelled_active(U, A, w - 1) >> 31));
  const bool right = bit < 31
                         ? ((s >> (bit + 1)) & 1u)
                         : (j < wpr - 1 && (labelled_active(U, A, w + 1) & 1u));
  unsigned best = BIG_KEY;
  if (up) best = min(best, (unsigned)key[*p - W]);
  if (down) best = min(best, (unsigned)key[*p + W]);
  if (left) best = min(best, (unsigned)key[*p - 1]);
  if (right) best = min(best, (unsigned)key[*p + 1]);
  return key[*p] | ((int)best & lmask);
}

// writes a grown key.  A key equal to BIG_KEY (level 127 with label
// 2^24 - 1 in 24-bit keys) reads as unlabelled, as in the plain version: the
// pixel stays in U and its slot keeps the level key.
__device__ __forceinline__ void put_key(int *key, unsigned *Un, int pp, int p,
                                        int k) {
  if (k != BIG_KEY)
    key[p] = k;
  else
    atomicOr(Un + (pp >> 5), 1u << (pp & 31));
}

// grows the n <= 2 * 32 front pixels of a warp's list: each lane takes two,
// and issues the loads of both before either store
__device__ __forceinline__ void grow_list(int *key, const unsigned *U,
                                          const unsigned *A, unsigned *Un,
                                          const int *list, int n, int lane,
                                          int H, int W, int wpr,
                                          unsigned long long magic,
                                          int lmask) {
  const int pa = lane < n ? list[lane] : -1;
  const int pb = lane + 32 < n ? list[lane + 32] : -1;
  int p_a = 0, p_b = 0, k_a = 0, k_b = 0;
  if (pa >= 0) k_a = new_key(key, U, A, pa, H, W, wpr, magic, lmask, &p_a);
  if (pb >= 0) k_b = new_key(key, U, A, pb, H, W, wpr, magic, lmask, &p_b);
  if (pa >= 0) put_key(key, Un, pa, p_a, k_a);
  if (pb >= 0) put_key(key, Un, pb, p_b, k_b);
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
flood_block_kernel(const float *__restrict__ value,
                   const int *__restrict__ markers,
                   const uint8_t *__restrict__ mask, int *__restrict__ out,
                   int *key_plane, int *order, int *__restrict__ steps_out,
                   unsigned long long *__restrict__ work_out, int H, int W,
                   int n_levels, int inner_steps, int label_bits,
                   int max_final_iters) {
  extern __shared__ unsigned s_dyn[];
  __shared__ float s_red[2][BLOCK_THREADS / 32];
  __shared__ float s_span[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = BLOCK_THREADS / 32;
  const int b = blockIdx.x;
  const int HW = H * W;
  const size_t base = (size_t)b * HW;
  const int wpr = (W + 31) >> 5;  // words per row
  const int nw = H * wpr;
  const unsigned long long magic = ((1ull << 32) + wpr - 1) / wpr;
  const int lmask = (1 << label_bits) - 1;
  unsigned *U = s_dyn, *Un = s_dyn + nw, *A = s_dyn + 2 * nw;
  int *start = (int *)(s_dyn + 3 * nw);  // n_levels + 1: counts, then starts
  int *cursor = start + n_levels + 1;    // n_levels
  int *s_front = cursor + n_levels;      // FRONT_CAP per warp
  const float *v = value + base;
  const int *mk = markers + base;
  const uint8_t *m = mask + base;
  int *key = key_plane + base;
  int *ord = order + base;

  // ---- per-image min / max over the mask (block reduction) ----
  float lo = BIG_F, hi = -BIG_F;
#pragma unroll 4
  for (int p = tid; p < HW; p += BLOCK_THREADS) {
    const bool in = m[p];
    const float x = v[p];
    lo = in ? fminf(lo, x) : lo;
    hi = in ? fmaxf(hi, x) : hi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
  }
  if (lane == 0) {
    s_red[0][warp] = lo;
    s_red[1][warp] = hi;
  }
  for (int l = tid; l <= n_levels; l += BLOCK_THREADS) start[l] = 0;
  __syncthreads();
  if (warp == 0) {
    lo = lane < nwarps ? s_red[0][lane] : BIG_F;
    hi = lane < nwarps ? s_red[1][lane] : -BIG_F;
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
    }
    if (lane == 0) {
      s_span[0] = lo;
      s_span[1] = fmaxf(__fsub_rn(hi, lo), 1e-20f);
    }
  }
  __syncthreads();
  const float vmin = s_span[0], span = s_span[1];
  const float scale = (float)(n_levels - 1);

  // ---- keys, U, and the histogram of levels; a warp per word, a lane per
  // pixel, four words at a time: the loads of all four first, none waiting
  // on the mask (lanes past W read the row's last pixel).  Each pixel's
  // level (-1 outside the mask) waits in `out` for the scatter ----
  for (int w0 = warp; w0 < nw; w0 += BATCH * nwarps) {
    int pw[BATCH], mkv[BATCH];
    bool in[BATCH], inside[BATCH];
    float x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int wi = min(w0 + k * nwarps, nw - 1);
      const int r = div_rows(wi, magic), c = ((wi - r * wpr) << 5) + lane;
      pw[k] = r * W + min(c, W - 1);
      inside[k] = c < W;
      in[k] = inside[k] && m[pw[k]];
      x[k] = v[pw[k]];
      mkv[k] = mk[pw[k]];
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int wi = w0 + k * nwarps;
      if (wi >= nw) break;  // the same in every lane
      const float t =
          __fmul_rn(__fdiv_rn(__fsub_rn(x[k], vmin), span), scale);
      // truncation toward zero, like astype(int32), then the clip
      const int q = in[k] ? min(max((int)t, 0), n_levels - 1) : -1;
      const int a = max(q, 0) << label_bits;
      const int seeded = (in[k] && mkv[k] > 0) ? (a | mkv[k]) : BIG_KEY;
      const bool unlabelled = in[k] && seeded == BIG_KEY;  // BIG_KEY seeds
      if (inside[k]) {
        key[pw[k]] = !in[k] ? BIG_KEY : (unlabelled ? a : seeded);
        out[base + pw[k]] = q;
      }
      const unsigned u = __ballot_sync(FULL, unlabelled);
      if (lane == 0) {
        U[wi] = u;
        A[wi] = 0;
      }
      if (q >= 0) atomicAdd(start + q, 1);
    }
  }
  __syncthreads();

  // ---- exclusive scan of the counts (one warp, up to 8 levels a lane) ----
  if (warp == 0) {
    const int per = (n_levels + 31) >> 5;
    const int i0 = min(lane * per, n_levels), i1 = min(i0 + per, n_levels);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += start[i];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    int run = incl - sum;
    for (int i = i0; i < i1; ++i) {
      const int cnt = start[i];
      start[i] = run;
      cursor[i] = run;
      run += cnt;
    }
    if (lane == 31) start[n_levels] = incl;
  }
  __syncthreads();

  // ---- scatter: the padded index (word << 5 | bit) of every in-mask
  // pixel, sorted by level; four words' levels loaded at a time ----
  for (int w0 = warp; w0 < nw; w0 += BATCH * nwarps) {
    int qs[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int wi = min(w0 + k * nwarps, nw - 1);
      const int r = div_rows(wi, magic), c = ((wi - r * wpr) << 5) + lane;
      qs[k] = c < W ? out[base + r * W + c] : -1;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int wi = w0 + k * nwarps, q = qs[k];
      if (wi < nw && q >= 0) ord[atomicAdd(cursor + q, 1)] = (wi << 5) | lane;
    }
  }
  __syncthreads();

  // ---- the steps ----
  long long examined = 0;
  int *list = s_front + warp * FRONT_CAP;  // this warp's front pixels
  // the front bits of word w (u = U[w], a = A[w]): unlabelled active
  // pixels next to a labelled active one.  Most words have no unlabelled
  // active pixel and skip the neighbours.
  auto front = [&](int w, unsigned u, unsigned a) {
    const unsigned ua = u & a;
    if (!ua) return 0u;
    const int r = div_rows(w, magic), j = w - r * wpr;
    const unsigned s = a & ~u;
    unsigned d = (s << 1) | (s >> 1);
    if (r > 0) d |= labelled_active(U, A, w - wpr);
    if (r < H - 1) d |= labelled_active(U, A, w + wpr);
    if (j > 0) d |= labelled_active(U, A, w - 1) >> 31;
    if (j < wpr - 1) d |= labelled_active(U, A, w + 1) << 31;
    examined += __popc(ua);
    return ua & d;
  };
  auto step = [&]() {
    unsigned changed = 0;
    int filled = 0;  // entries in the list (the same in every lane)
    // thread tid owns words tid, tid + BLOCK_THREADS, ...: two at a time,
    // the loads of both first
    for (int wb = warp << 5; wb < nw; wb += 2 * BLOCK_THREADS) {
      const int w0 = wb + lane, w1 = w0 + BLOCK_THREADS;
      unsigned u0 = 0, a0 = 0, u1 = 0, a1 = 0;
      if (w0 < nw) {
        u0 = U[w0];
        a0 = A[w0];
      }
      if (w1 < nw) {
        u1 = U[w1];
        a1 = A[w1];
      }
      const unsigned c0 = front(w0, u0, a0), c1 = front(w1, u1, a1);
      if (w0 < nw) Un[w0] = u0 & ~c0;
      if (w1 < nw) Un[w1] = u1 & ~c1;
      changed |= c0 | c1;
      if (__any_sync(FULL, c0 | c1)) {
        // list the front pixels in the warp's list, lane by lane (each
        // lane's of w0, then of w1); grow the list whenever it is full
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
            const unsigned rest = first ? rest0 : rest1;
            list[filled + excl + i - done] =
                ((first ? w0 : w1) << 5) | (__ffs(rest) - 1);
            if (first)
              rest0 &= rest0 - 1;
            else
              rest1 &= rest1 - 1;
          }
          filled += take;
          done += take;
          if (filled == FRONT_CAP) {
            __syncwarp();  // the list and Un stored before they are read
            grow_list(key, U, A, Un, list, filled, lane, H, W, wpr, magic,
                      lmask);
            __syncwarp();
            filled = 0;
          }
        }
      }
    }
    if (filled) {
      __syncwarp();
      grow_list(key, U, A, Un, list, filled, lane, H, W, wpr, magic, lmask);
    }
    const int any = __syncthreads_or(changed != 0);
    unsigned *t = U;
    U = Un;
    Un = t;
    return any;
  };

  int nsteps = 0;
  // this thread's first pixel of the next level, loaded a level ahead
  int next = tid < start[1] ? ord[tid] : 0;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int s0 = start[lvl], e = start[lvl + 1];
    if (s0 < e) {  // the same for every thread: A grows or not
      if (s0 + tid < e) atomicOr(A + (next >> 5), 1u << (next & 31));
      for (int i = s0 + tid + BLOCK_THREADS; i < e; i += BLOCK_THREADS) {
        const int pp = ord[i];
        atomicOr(A + (pp >> 5), 1u << (pp & 31));
      }
      __syncthreads();
    }
    if (lvl + 1 < n_levels && e + tid < start[lvl + 2]) next = ord[e + tid];
    for (int s = 0; s < inner_steps; ++s) {
      const int any = step();
      ++nsteps;
      if (!any) break;
    }
  }
  for (int it = 0; it < max_final_iters; ++it) {
    const int any = step();
    ++nsteps;
    if (!any) break;
  }

  // ---- labels: the key's label where the pixel is labelled ----
#pragma unroll 4
  for (int wi = warp; wi < nw; wi += nwarps) {
    const int r = div_rows(wi, magic), c = ((wi - r * wpr) << 5) + lane;
    if (c < W) {
      const int p = r * W + c;
      const int k = key[p];
      const bool labelled = !((U[wi] >> lane) & 1u) && k != BIG_KEY;
      out[base + p] = labelled ? (k & lmask) : 0;
    }
  }
  if (tid == 0) steps_out[b] = nsteps;
  if (work_out) {
    for (int o = 16; o > 0; o >>= 1)
      examined += __shfl_xor_sync(FULL, examined, o);
    if (lane == 0 && examined)
      atomicAdd(work_out + b, (unsigned long long)examined);
  }
}

extern "C" int flood_block_launch(const void *value, const void *markers,
                                  const void *mask, void *out, void *key,
                                  void *order, void *steps, void *work, int B,
                                  int H, int W, int n_levels, int inner_steps,
                                  int label_bits, int max_final_iters,
                                  void *stream) {
  // U (two buffers) and A, the level starts and cursors, the front lists:
  // 226 KB at 768^2 with 256 levels, the most the wrapper sends here
  const size_t smem =
      sizeof(unsigned) * (3 * (size_t)H * ((W + 31) / 32) +
                          2 * (size_t)n_levels + 1 +
                          (BLOCK_THREADS / 32) * FRONT_CAP);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flood_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flood_block_kernel<<<B, BLOCK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float *)value, (const int *)markers, (const uint8_t *)mask,
      (int *)out, (int *)key, (int *)order, (int *)steps,
      (unsigned long long *)work, H, W, n_levels, inner_steps, label_bits,
      max_final_iters);
  return (int)cudaGetLastError();
}
