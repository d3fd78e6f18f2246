// The attention of a Cellpose-SAM block (models/vit_sam.py::Attention) with
// SAM's decomposed relative positions in its logits, in one launch.
//
// Replaces no TPU kernel: the JAX package has no vision transformer.  On the
// card the block's attention had run as three steps: two einsums for the
// relative products, one 0/1 product that spread rel_h + rel_w over the
// keys into a (B, heads, N, N) bf16 bias (0.5 GB a block-forward at the
// cell's 16 tiles of 1,024 tokens), and cuDNN's fused attention reading that
// bias back as its mask.  Here nothing of size N^2 leaves the registers.
//
// For one map (image b, head h), with g x g tokens (N = g^2), head width HD,
// query i = (qh, qw) = (i / g, i % g) and key j = (kh, kw):
//
//   logit[i, j] = (q_i . k_j) / sqrt(HD) + rel_h[i, kh] + rel_w[i, kw]
//   rel_h[i, kh] = q_i . rel_pos_h[qh - kh + g - 1]   (q unscaled, as SAM's
//   rel_w[i, kw] = q_i . rel_pos_w[qw - kw + g - 1]    add_decomposed_rel_pos)
//   out_i = softmax_j(logit[i, :]) . v
//
// q, k and v are read where the qkv projection wrote them: qkv is (B, N, 3D)
// bf16, D = heads * HD, q of head h at column h * HD, k at D + h * HD, v at
// 2D + h * HD.  The output is bf16 (B, N, D), head h at column h * HD, the
// layout the block's `proj` reads.
//
// Design: flash attention (online softmax over tiles of 64 keys, nothing of
// size N^2 in memory), a block owning 128 queries of one map:
//
// - Prologue: the block's queries and both tables (rounded to bf16, as the
//   einsums under autocast rounded them) go to shared memory; each warp
//   computes q . table^T on the tensor cores (`mma.sync`) for its 16 rows
//   and all 2g - 1 table rows, and writes the entries each query uses,
//   shifted to [row][kh] and [row][kw] (Transformer-XL's relative shift), in
//   float32 and times log2(e), to shared memory.
// - Each logit in registers becomes S * log2(e) / sqrt(HD) + rel_h + rel_w;
//   online softmax in float32 with exp2; P rounded to bf16 and P v into
//   float32 sums, rescaled only where a row's maximum moved.
// - g = 32 at head 64 (the published 256^2 tiles of 8 px patches): two
//   warpgroups of 64 rows on `wgmma`, q, k and v in shared memory with the
//   128-byte swizzle, k and v loaded one tile ahead by `cp.async`.  A step
//   issues S = q k_t^T and O += P_{t-1} v_{t-1} together and runs the
//   softmax of tile t while the second product runs.  A key tile is two
//   image rows, so each thread's columns take the same kw in every tile and
//   their rel_w stays in registers; the tile's two rel_h values a row join
//   the row maximum and the exponent's offset, not each logit.
// - Any other grid (1 to 64) and head 16: four warps of 32 rows on
//   `mma.sync` (each k or v fragment read from shared memory feeds two
//   products), both terms read from shared memory per logit, the ragged
//   last tiles masked.
//
// What bounds it on the H100: the two products, 4 N^2 HD operations a map,
// over the tensor cores' 989 TFLOP/s, against q, k, v and the output, 8 N HD
// bytes a map, over 3.35 TB/s: at N = 1024, HD = 64 the operations, 1.7x
// the bytes (benchmark/metrics/rel_attention_roofline.py).  At head 64 the
// softmax's exponentials (16 a clock an SM) take as long as the products at
// the tensor cores' peak, so the two have to overlap; the relative products
// (4 g HD operations a query) are left out of the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int BM = 128;  // queries a block
constexpr int BN = 64;   // keys a tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zeros where !valid (no byte is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void *src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float *c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t *>(&v);
}

// --- wgmma (the g = 32, head 64 path) ----------------------------------------

// Keeps the compiler from moving a use of a register across the
// asynchronous products that read or write it.
__device__ __forceinline__ void pin(float &r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t &r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory matrix descriptor: start address >> 4 in bits 0-13, the
// leading offset >> 4 in bits 16-29, the stride offset >> 4 in bits 32-45,
// 128-byte swizzle (1) in bits 62-63.  Rows of 128 bytes, 8-row groups 1024
// bytes apart; the leading offset is the distance between 64-column chunks
// of an operand read with N contiguous (one chunk here).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, int leading) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(leading >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 f32 of the warpgroup) (+)= A (64 x 16, K contiguous, smem) *
// B (16 x 64, K contiguous, smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16, bf16 in registers, mma.sync's A layout a
// warp) * B (16 x 64, N contiguous, smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// --- shared memory -----------------------------------------------------------

// The block's shared memory, in bytes from a 1024-byte aligned base: q, two
// buffers of k and of v, the two tables (rounded to bf16), then rel_h and
// rel_w in float32 (rows of g + 1, against bank conflicts).  On the wgmma
// path q, k and v lie in rows of 128 bytes with the 128-byte swizzle that
// `wgmma` reads (16-byte piece c of row r at piece c ^ (r % 8)); on the
// mma.sync path in rows of HD + 8 bf16, so that `ldmatrix` reads eight rows
// without bank conflicts.  The tables always take rows of HD + 8.
struct Layout {
  int ld, lt, tp, rs;  // bytes a q/k/v row, a table row; table rows; rel row
  int q, k, v, t, rel, bytes;
  __host__ __device__ Layout(int hd, int g, bool swizzled) {
    ld = swizzled ? 128 : (hd + 8) * 2;
    lt = (hd + 8) * 2;
    tp = (2 * g - 1 + 15) / 16 * 16;
    rs = g + 1;
    q = 0;
    k = q + BM * ld;
    v = k + 2 * BN * ld;
    t = v + 2 * BN * ld;
    rel = t + 2 * tp * lt;
    bytes = rel + 2 * BM * rs * 4;
  }
};

// byte offset of 16-byte piece c of row r
template <bool SW>
__device__ __forceinline__ uint32_t piece(int r, int c, int ld) {
  return SW ? r * 128 + ((c ^ (r & 7)) << 4) : r * ld + (c << 4);
}

// rows [r0, r0 + rows) of one head's HD columns at `src` (row stride
// `stride` elements) -> shared memory at `dst`, zero past row n
template <int HD, int NT, bool SW>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16 *src,
                                          int64_t stride, int r0, int rows,
                                          int n, int ld) {
  constexpr int CHUNKS = HD / 8;  // 16-byte pieces a row
  for (int c = threadIdx.x; c < rows * CHUNKS; c += NT) {
    const int r = c / CHUNKS, p = c % CHUNKS;
    const bool valid = r0 + r < n;
    cp_async16(dst + piece<SW>(r, p, ld),
               src + (valid ? (int64_t)(r0 + r) * stride : 0) + p * 8, valid);
  }
}

// Both tables, rounded to bf16, into shared rows of HD + 8 (zero past row
// 2g - 1).
template <int HD, int NT>
__device__ __forceinline__ void load_tables(unsigned char *st,
                                            const float *rel_pos_h,
                                            const float *rel_pos_w,
                                            const Layout &L, int P) {
  for (int e = threadIdx.x; e < 2 * L.tp * (HD / 2); e += NT) {
    const int tab = e / (L.tp * (HD / 2)), r = (e / (HD / 2)) % L.tp;
    const int c = 2 * (e % (HD / 2));
    float2 x = make_float2(0.f, 0.f);
    if (r < P)
      x = *reinterpret_cast<const float2 *>((tab ? rel_pos_w : rel_pos_h) +
                                            r * HD + c);
    *reinterpret_cast<__nv_bfloat162 *>(st + (tab * L.tp + r) * L.lt +
                                        c * 2) =
        __floats2bfloat162_rn(x.x, x.y);
  }
}

// q . table^T on the tensor cores for the warp's 16 rows (from `wrow`) and
// every table row, the entries each query uses written shifted to
// [row][kh] and [row][kw] (Transformer-XL's relative shift), float32 times
// log2(e).  qf holds the warp's q fragments (mma.sync's A layout).
template <int KC>
__device__ __forceinline__ void relative_products(const uint32_t (&qf)[KC][4],
                                                  uint32_t st, float *srel,
                                                  const Layout &L, int wrow,
                                                  int m0, int g) {
  const int lane = threadIdx.x % 32, tq = lane % 4, gq = lane / 4;
  const int N = g * g, P = 2 * g - 1;
  int qpos[2][2];  // [hf][table]: qh, qw of rows gq and gq + 8
  bool qin[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = m0 + wrow + 8 * hf + gq;
    qin[hf] = i < N;
    qpos[hf][0] = i / g;
    qpos[hf][1] = i - qpos[hf][0] * g;
  }
  for (int tab = 0; tab < 2; ++tab) {
    const uint32_t tt = st + tab * L.tp * L.lt;
    float *rel = srel + tab * BM * L.rs;
    for (int np = 0; np < L.tp / 16; ++np) {
      float d[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t r[4];
        ldsm_x4(r, tt + (np * 16 + lane % 8 + (lane / 16) * 8) * L.lt +
                       kc * 32 + ((lane / 8) % 2) * 16);
        mma16816(d[0], qf[kc], r[0], r[1]);
        mma16816(d[1], qf[kc], r[2], r[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = np * 16 + nt * 8 + 2 * tq + e;
            const int kk = qpos[hf][tab] + g - 1 - c;
            if (qin[hf] && c < P && kk >= 0 && kk < g)
              rel[(wrow + 8 * hf + gq) * L.rs + kk] = d[nt][2 * hf + e] * LOG2E;
          }
    }
  }
}

// --- the g = 32, head 64 path: wgmma -----------------------------------------
//
// A thread's columns 8n + 2 tq + e of a tile take kw = 8 (n % 4) + 2 tq + e
// in every tile and key row 2t + n / 4.
constexpr int WG_THREADS = 256;

__device__ __forceinline__ void wgmma_path(
    const __nv_bfloat16 *__restrict__ qkv, const float *__restrict__ rel_pos_h,
    const float *__restrict__ rel_pos_w, __nv_bfloat16 *__restrict__ out,
    int heads, unsigned char *smem) {
  constexpr int HD = 64, g = 32, N = g * g, P = 2 * g - 1;
  constexpr int NTILES = N / BN;
  constexpr float SCALE = LOG2E / 8.f;  // log2(e) / sqrt(HD)
  const Layout L(HD, g, true);
  const uint32_t base = smem_addr(smem);
  const uint32_t sq = base + L.q, sk = base + L.k, sv = base + L.v;
  float *srel = reinterpret_cast<float *>(smem + L.rel);
  const int rs = L.rs;

  const int D = heads * HD;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * BM;
  const int64_t stride = 3 * (int64_t)D;
  const __nv_bfloat16 *qp = qkv + (int64_t)b * N * stride + h * HD;
  const __nv_bfloat16 *kp = qp + D, *vp = qp + 2 * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, gq = lane / 4;
  const int wg = warp / 4, wrow = warp * 16;  // warpgroup; the warp's rows

  // --- prologue: q, k_0, the tables; then k_1 and v_0 in flight
  load_rows<HD, WG_THREADS, true>(sq, qp, stride, m0, BM, N, 128);
  load_rows<HD, WG_THREADS, true>(sk, kp, stride, 0, BN, N, 128);
  cp_async_commit();
  load_rows<HD, WG_THREADS, true>(sk + BN * 128, kp, stride, BN, BN, N, 128);
  load_rows<HD, WG_THREADS, true>(sv, vp, stride, 0, BN, N, 128);
  cp_async_commit();
  load_tables<HD, WG_THREADS>(smem + L.t, rel_pos_h, rel_pos_w, L, P);
  cp_async_wait<1>();
  fence_async_shared();
  __syncthreads();

  {
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      const int r = wrow + lane % 16;
      ldsm_x4(qf[kc], sq + piece<true>(r, kc * 2 + lane / 16, 128));
    }
    relative_products<HD / 16>(qf, base + L.t, srel, L, wrow, m0, g);
  }
  __syncwarp();
  const float *relh = srel + (wrow + gq) * rs;  // row gq; gq + 8 at + 8 rs
  float rw[2][4][2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rw[hf][n][e] = relh[BM * rs + hf * 8 * rs + n * 8 + 2 * tq + e];

  const uint64_t dq = desc128(sq + wg * 64 * 128, 16);
  float s[32], o[32];
  uint32_t pa[BN / 16][4], pn[BN / 16][4];
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F}, lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  // S = q k_t^T, issued (4 products over the head width)
  auto issue_qk = [&](int t) {
    const uint64_t dk = desc128(sk + (t & 1) * BN * 128, 16);
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss(s, dq + 2 * kc, dk + 2 * kc, kc);
    wgmma_commit();
  };
  // O += P v_t, issued (4 products over the tile's keys)
  auto issue_pv = [&](int t) {
    const uint64_t dv = desc128(sv + (t & 1) * BN * 128, BN * 128);
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(o[i]);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int c = 0; c < 4; ++c) pin(pa[kc][c]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(o, pa[kc], dv + 128 * kc);
    wgmma_commit();
  };
  // after the wait for O += P v: O is written, P may be overwritten
  auto pin_pv = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(o[i]);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int c = 0; c < 4; ++c) pin(pa[kc][c]);
  };
  // the softmax of tile t on S: logits times log2(e), rows gq and gq + 8;
  // P into pn, the factor for the sums into alpha
  auto softmax = [&](int t, float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float rh0 = relh[hf * 8 * rs + 2 * t];
      const float rh1 = relh[hf * 8 * rs + 2 * t + 1];
      float m0x = -CUDART_INF_F, m1x = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = fmaf(s[4 * n + 2 * hf + e], SCALE, rw[hf][n % 4][e]);
          s[4 * n + 2 * hf + e] = x;
          if (n < 4)
            m0x = fmaxf(m0x, x);
          else
            m1x = fmaxf(m1x, x);
        }
      float mx = fmaxf(m0x + rh0, m1x + rh1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(mrow[hf], mx);
      alpha[hf] = ex2(mrow[hf] - mnew);
      mrow[hf] = mnew;
      const float sub0 = mnew - rh0, sub1 = mnew - rh1;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[4 * n + 2 * hf + e] - (n < 4 ? sub0 : sub1));
          s[4 * n + 2 * hf + e] = p;
          sum += p;
        }
      lrow[hf] = lrow[hf] * alpha[hf] + sum;
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      pn[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pn[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pn[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pn[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
    }
  };

  // --- tile 0
  issue_qk(0);
  wgmma_wait<0>();
  {
    float alpha[2];
    softmax(0, alpha);
  }
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
    for (int c = 0; c < 4; ++c) pa[kc][c] = pn[kc][c];

  // --- tiles 1 .. NTILES - 1: k_t and v_{t-1} were loaded in step t - 1
  for (int t = 1; t < NTILES; ++t) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (t + 1 < NTILES)
      load_rows<HD, WG_THREADS, true>(sk + ((t + 1) & 1) * BN * 128, kp,
                                      stride, (t + 1) * BN, BN, N, 128);
    load_rows<HD, WG_THREADS, true>(sv + (t & 1) * BN * 128, vp, stride,
                                    t * BN, BN, N, 128);
    cp_async_commit();
    issue_qk(t);
    issue_pv(t - 1);
    wgmma_wait<1>();
    float alpha[2];
    softmax(t, alpha);
    wgmma_wait<0>();
    pin_pv();
    rescale(alpha);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int c = 0; c < 4; ++c) pa[kc][c] = pn[kc][c];
  }
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  issue_pv(NTILES - 1);
  wgmma_wait<0>();
  pin_pv();

  // --- normalise and write (B, N, D)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = lrow[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int i = m0 + wrow + 8 * hf + gq;
    __nv_bfloat16 *dst = out + ((int64_t)b * N + i) * D + h * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t *>(dst + n * 8) =
          pack_bf16(o[4 * n + 2 * hf] * inv, o[4 * n + 2 * hf + 1] * inv);
  }
}

// --- any grid 1..64, head 16 or 64: mma.sync ---------------------------------
constexpr int MS_THREADS = 128;
constexpr int MT = BM / (16 * 4);

template <int HD>
__device__ __forceinline__ void mma_sync_path(
    const __nv_bfloat16 *__restrict__ qkv, const float *__restrict__ rel_pos_h,
    const float *__restrict__ rel_pos_w, __nv_bfloat16 *__restrict__ out,
    int heads, int g, unsigned char *smem) {
  constexpr int KC = HD / 16;  // 16-wide chunks of the head width
  constexpr float SCALE = LOG2E / (HD == 64 ? 8.f : 4.f);  // / sqrt(HD)

  const Layout L(HD, g, false);
  const uint32_t base = smem_addr(smem);
  const uint32_t sq = base + L.q, sk = base + L.k, sv = base + L.v;
  float *srel = reinterpret_cast<float *>(smem + L.rel);
  const int ld = L.ld, rs = L.rs;

  const int N = g * g, D = heads * HD, P = 2 * g - 1;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int m0 = blockIdx.x * BM;
  const int64_t stride = 3 * (int64_t)D;
  const __nv_bfloat16 *qp = qkv + (int64_t)b * N * stride + h * HD;
  const __nv_bfloat16 *kp = qp + D, *vp = qp + 2 * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, gq = lane / 4;  // mma fragment column, row
  const int wrow = warp * 16 * MT;         // the warp's first row
  const int ntiles = (N + BN - 1) / BN;

  // --- prologue
  load_rows<HD, MS_THREADS, false>(sq, qp, stride, m0, BM, N, ld);
  cp_async_commit();
  load_rows<HD, MS_THREADS, false>(sk, kp, stride, 0, BN, N, ld);
  load_rows<HD, MS_THREADS, false>(sv, vp, stride, 0, BN, N, ld);
  cp_async_commit();
  load_tables<HD, MS_THREADS>(smem + L.t, rel_pos_h, rel_pos_w, L, P);
  for (int e = threadIdx.x; e < 2 * BM * rs; e += MS_THREADS) srel[e] = 0.f;
  cp_async_wait<1>();
  __syncthreads();

  // q fragments of the warp's rows (A operand, row-major)
  uint32_t qf[MT][KC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[mt][kc], sq + (wrow + mt * 16 + lane % 16) * ld + kc * 32 +
                              (lane / 16) * 16);
    relative_products<KC>(qf[mt], base + L.t, srel, L, wrow + mt * 16, m0, g);
  }
  __syncwarp();

  // the thread's row (mt, hf) of rel_h starts at relh + (16 mt + 8 hf) rs,
  // of rel_w at BM rs further
  const float *relh = srel + (wrow + gq) * rs;
  float o[MT][HD / 8][4] = {};
  float mrow[MT][2], lrow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mrow[mt][hf] = -CUDART_INF_F;
      lrow[mt][hf] = 0.f;
    }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_rows<HD, MS_THREADS, false>(sk + (buf ^ 1) * BN * ld, kp, stride,
                                       (t + 1) * BN, BN, N, ld);
      load_rows<HD, MS_THREADS, false>(sv + (buf ^ 1) * BN * ld, vp, stride,
                                       (t + 1) * BN, BN, N, ld);
      cp_async_commit();
    }
    const uint32_t kt = sk + buf * BN * ld, vt = sv + buf * BN * ld;

    float s[MT][BN / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t r[4];
        ldsm_x4(r, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * ld +
                       kc * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], qf[mt][kc], r[0], r[1]);
          mma16816(s[mt][2 * np + 1], qf[mt][kc], r[2], r[3]);
        }
      }

    float alpha[MT][2];
    bool moved = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float *rh = relh + (16 * mt + 8 * hf) * rs;
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = t * BN + n * 8 + 2 * tq + e;
            const int kh = j / g, kw = j - kh * g;
            const float x = j < N ? fmaf(s[mt][n][2 * hf + e], SCALE,
                                         rh[kh] + rh[BM * rs + kw])
                                  : -CUDART_INF_F;
            s[mt][n][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(mrow[mt][hf], mx);
        alpha[mt][hf] = ex2(mrow[mt][hf] - mnew);
        moved |= alpha[mt][hf] != 1.f;
        mrow[mt][hf] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[mt][n][2 * hf + e] - mnew);
            s[mt][n][2 * hf + e] = p;
            sum += p;
          }
        lrow[mt][hf] = lrow[mt][hf] * alpha[mt][hf] + sum;
      }
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[mt][n][c] *= alpha[mt][c / 2];
    }

    // P v: P as the A operand from the S fragments of key columns
    // 16 kc .. 16 kc + 15
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t r[4];
        ldsm_x4_t(r, vt + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ld +
                         dp * 32 + (lane / 16) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(o[mt][2 * dp], pa[mt], r[0], r[1]);
          mma16816(o[mt][2 * dp + 1], pa[mt], r[2], r[3]);
        }
      }
    }
  }

  // --- normalise and write (B, N, D)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = lrow[mt][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int i = m0 + wrow + 16 * mt + 8 * hf + gq;
      if (i < N) {
        __nv_bfloat16 *dst = out + ((int64_t)b * N + i) * D + h * HD + 2 * tq;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<uint32_t *>(dst + n * 8) =
              pack_bf16(o[mt][n][2 * hf] * inv, o[mt][n][2 * hf + 1] * inv);
      }
    }
}

constexpr int threads_of(int G) { return G == 32 ? WG_THREADS : MS_THREADS; }

// G: 32 for g == 32 at head 64 (wgmma), 0 for any g in 1..64 (mma.sync)
template <int HD, int G>
__global__ void __launch_bounds__(threads_of(G), 2)
    rel_attention_kernel(const __nv_bfloat16 *__restrict__ qkv,
                         const float *__restrict__ rel_pos_h,
                         const float *__restrict__ rel_pos_w,
                         __nv_bfloat16 *__restrict__ out, int heads, int g) {
  static_assert(HD == 16 || HD == 64, "head width 16 or 64");
  static_assert(G == 0 || (G == 32 && HD == 64), "wgmma path: g 32, head 64");
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle (the launch adds 1 KB)
  unsigned char *smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  if constexpr (G == 32)
    wgmma_path(qkv, rel_pos_h, rel_pos_w, out, heads, smem);
  else
    mma_sync_path<HD>(qkv, rel_pos_h, rel_pos_w, out, heads, g, smem);
}

constexpr int MAX_DEVICES = 64;

// dynamic shared memory of a launch: the layout and 1 KB for its alignment
int shared_bytes(int hd, int g) {
  return Layout(hd, g, hd == 64 && g == 32).bytes + 1024;
}

template <int HD, int G>
int launch(const void *qkv, const void *rel_pos_h, const void *rel_pos_w,
           void *out, int B, int heads, int g, cudaStream_t stream) {
  // the dynamic shared memory this kernel may take, per device: the
  // attribute binds on the current device only, and a mesh launches from
  // one host thread per device.  Raised under a lock, never lowered.
  static std::atomic<int> allowed[MAX_DEVICES];
  static std::mutex raising;
  const int bytes = shared_bytes(HD, g);
  auto kernel = rel_attention_kernel<HD, G>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::atomic<int> &cap = allowed[dev];
  if (bytes > cap.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(raising);
    if (bytes > cap.load(std::memory_order_relaxed)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      cap.store(bytes, std::memory_order_release);
    }
  }
  const dim3 grid((g * g + BM - 1) / BM, B * heads);
  kernel<<<grid, threads_of(G), bytes, stream>>>(
      (const __nv_bfloat16 *)qkv, (const float *)rel_pos_h,
      (const float *)rel_pos_w, (__nv_bfloat16 *)out, heads, g);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (B, g * g, 3 * heads * hd) bf16, contiguous; rel_pos_h, rel_pos_w:
// (2g - 1, hd) float32, contiguous; out: (B, g * g, heads * hd) bf16.
// hd 16 or 64, g 1..64 (the wrapper checks).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for another shape.
extern "C" int rel_attention_launch(const void *qkv, const void *rel_pos_h,
                                    const void *rel_pos_w, void *out, int B,
                                    int heads, int hd, int g, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || heads <= 0 || g < 1 || g > 64)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return g == 32 ? launch<64, 32>(qkv, rel_pos_h, rel_pos_w, out, B, heads,
                                    g, s)
                   : launch<64, 0>(qkv, rel_pos_h, rel_pos_w, out, B, heads, g,
                                   s);
  if (hd == 16)
    return launch<16, 0>(qkv, rel_pos_h, rel_pos_w, out, B, heads, g, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a launch at head width hd and grid g takes.
extern "C" int rel_attention_shared_bytes(int hd, int g) {
  return shared_bytes(hd, g);
}
