// Kernel K5: tensor-core matrix product C = A x B for Hopper, and the int8
// 3x3 convolution built on it.
//
// Replaces microbeseg_tpu's scripts/bench_pallas_int8_dot.py::make_matmul
// (kernel `matmul_kernel`): a product tiled over (M/bm, N/bn, K/bk) whose
// accumulator stays in fast memory across the K steps.  Entries:
//
//   matmul_int8_tma_launch / matmul_int8_launch   int8 x int8 -> int32 (exact)
//   matmul_bf16_tma_launch / matmul_bf16_launch   bf16 x bf16 -> f32 sums ->
//                                                 bf16 (rounded once)
//   conv3x3_int8_launch   the same int8 product for a 3x3 convolution whose
//                         9-tap operand is never written, with the
//                         dequantising epilogue fused in
//
// A is (M, K) row-major, B is (K, N) row-major, C is (M, N) row-major, for
// any M, K, N (the TPU kernel needs each divisible by its block).
//
// What bounds it on this card: on the int8 inference path M is 2^19..2^21,
// K is 576..2304 and N is 64 or 128, so the product is bound by the bytes of
// A and C, not by the tensor cores; at 2048^3 the operations bound it.  As a
// plain product the convolution's A is the (B*H*W, 9*C) operand of 3x3
// windows, nine times the activation's bytes, and its int32 result needs a
// second pass to become the next layer's input: most of the bytes exist only
// because of how the product is fed.
//
// The `_tma_` entries and the convolution (namespace `hopper`, one kernel
// template, `ring_kernel`):
//
// - Operands reach shared memory by TMA (`cp.async.bulk.tensor`) from tensor
//   maps that the C entry encodes per call and passes as `__grid_constant__`
//   parameters.  A tile row holds KS = 128 (products) or 64 (convolution)
//   bytes of K and is written with the 128- or 64-byte swizzle that `wgmma`
//   reads back without bank conflicts.  TMA fills coordinates outside a
//   tensor with zeros, which replaces every edge check on the loads.
// - A ring of 4 to 8 stages with a full and an empty `mbarrier` per stage.
//   One thread of a producer warpgroup (registers cut with `setmaxnreg`)
//   keeps the loads in flight; two consumer warpgroups each own 64 rows of
//   the 128 x BN tile (BN = 64, 128 or 256) and run `wgmma.mma_async`
//   m64nBNk32 (s8 -> s32) or m64nBNk16 (bf16 -> f32) with both operands read
//   from shared memory and the sums in registers.  One group of products
//   stays in flight while the next stage is waited for.
// - One persistent block per SM walks over the output tiles, so the producer
//   loads the next tile's stages while the consumers write the last tile's
//   results.
// - int8 `wgmma` takes both operands with K contiguous, so a first small
//   kernel writes B transposed and zero-padded, Bt (Np, Kp); it is a few
//   hundred kilobytes and stays in L2.  bf16 `wgmma` also reads an operand
//   with N contiguous, so a bf16 B whose rows are 16-byte aligned is loaded
//   as it is stored, in boxes of 64 columns, and no Bt is written.
// - The convolution reads x_q (B, H, W, C) int8, unpadded, through a 4-D
//   tensor map with a box of (64 channels, 128 pixels along W, 3 image rows,
//   1).  For the output pixels (b, y, x0 .. x0 + 127) the box at (c0, x0 +
//   dx - 1, y - 1, b) holds the A operands of the taps (dy = -1, 0, 1; dx):
//   three swizzled sub-tiles, one stage.  The zeros TMA returns outside the
//   tensor are the convolution's zero padding and cover a W that is no
//   multiple of 128.  A first small kernel writes the weights with K
//   contiguous and the taps ordered (dx, dy, c) to match.  Where they leave
//   room for 4 stages of A (9 * C * BN <= 96 KB: the flagship's level-0
//   layers), the weights are loaded once per block and stay in shared memory;
//   else they come through the ring beside A.
// - The convolution's epilogue writes float(acc) * scale[b, o] + bias[o] (two
//   roundings, no fused multiply-add) as float32 or bfloat16 into (B, H, W,
//   O), the channels-last tensor the next layer reads: per pixel the function
//   moves C bytes in and 2 or 4 bytes per output channel out.
// - Results leave the registers as whole 32-byte sectors: a quad of lanes
//   holds 8 neighbouring columns of a row as four pairs; 32-bit pairs go out
//   as they are, bfloat16 pairs are first traded inside the quad
//   (`quad_transpose`) so that each lane stores 16 bytes of one row.
// - TMA needs 16-byte-aligned rows; the wrapper sends other shapes to the
//   `mma.sync` kernel below, and convolutions whose C is no multiple of 64
//   through the 9-tap operand and `matmul_int8`.
//
// The `mma.sync` kernel (the first form of K5, kept for shapes whose rows of
// A are not 16-byte aligned):
//
// - The TPU grid's sequential K dimension becomes a loop inside the block;
//   a block owns a 128 x BN tile of C (BN = 64 or 128) and keeps its sums in
//   registers, so C is written once and A is read once per column block.
// - Per K tile of 64 bytes a row (64 int8 or 32 bf16 values) the 256
//   threads copy 128 rows of A and BN rows of Bt into shared memory.  The
//   next tile's global loads go into registers before the current tile's
//   products, so they overlap them.  Rows are padded to 80 bytes, which
//   puts the eight rows x four words a warp reads per fragment in 32
//   different banks.
// - Eight warps each multiply a 32 x 32 (BN = 64) or 64 x 32 (BN = 128)
//   sub-tile with `mma.sync.aligned.m16n8k32.s32.s8.s8.s32` or
//   `mma.sync.aligned.m16n8k16.f32.bf16.bf16.f32`.  In bytes the two
//   fragment layouts are the same (a thread holds 4 consecutive bytes of K
//   per register), so one kernel body serves both types.  Registers are
//   capped so that three blocks (BN = 64) or two (BN = 128) share an SM and
//   one block's loads hide behind another's products.
// - Edges: rows beyond M and columns of K beyond its end load as zeros, and
//   stores beyond M or N are skipped.  When A's rows are not 16-byte aligned
//   the A tile is gathered value by value instead of with 16-byte loads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // rows of C per block
constexpr int TILE_BYTES = 64;  // bytes of K per shared-memory tile row
constexpr int ROW_WORDS = 20;   // 16 words of data + 4 of padding per row
constexpr int THREADS = 256;    // 8 warps

struct Int8 {
    typedef uint8_t raw_t;  // the operand's bits
    typedef int acc_t;
    typedef int out_t;
    static __device__ __forceinline__ void mma(int (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
    static __device__ __forceinline__ void store(int* p, int v) { *p = v; }
    static __device__ __forceinline__ void store2(int* p, int v0, int v1) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    }
};

struct Bf16 {
    typedef uint16_t raw_t;
    typedef float acc_t;
    typedef __nv_bfloat16 out_t;
    static __device__ __forceinline__ void mma(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
        *p = __float2bfloat16_rn(v);
    }
    static __device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                                  float v1) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    }
};

// Bt[n][k] = B[k][n], zero where k >= K or n >= N.  B is (K, N) row-major,
// Bt is (Np, Kp) row-major; Kp and Np are multiples of 32.
template <typename T>
__global__ void transpose_pad(const T* __restrict__ B, T* __restrict__ Bt,
                              int K, int N, int Kp) {
    __shared__ T tile[32][33];
    const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int k = k0 + i, n = n0 + threadIdx.x;
        tile[i][threadIdx.x] =
            (k < K && n < N) ? B[(size_t)k * N + n] : (T)0;
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int n = n0 + i, k = k0 + threadIdx.x;
        Bt[(size_t)n * Kp + k] = tile[threadIdx.x][i];
    }
}

// The same result with 32-bit loads and stores, for a B whose rows are 4-byte
// aligned (B's address and N * sizeof(T) multiples of 4): a block of (32, 8)
// threads moves a tile of 32 rows of K by TN = 32 * (4 / sizeof(T)) columns
// of N.
template <typename T>
__global__ void transpose_pad_words(const T* __restrict__ B,
                                    T* __restrict__ Bt, int K, int N, int Kp,
                                    int Np) {
    constexpr int VEC = 4 / (int)sizeof(T), TN = 32 * VEC;
    __shared__ __align__(4) T tile[32][TN + VEC];
    const int k0 = blockIdx.x * 32, n0 = blockIdx.y * TN;
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int k = k0 + i, n = n0 + threadIdx.x * VEC;
        uint32_t w = 0u;
        if (k < K && n < N)
            w = __ldg(reinterpret_cast<const uint32_t*>(B + (size_t)k * N + n));
        *reinterpret_cast<uint32_t*>(&tile[i][threadIdx.x * VEC]) = w;
    }
    __syncthreads();
    constexpr int WORDS = 32 / VEC;   // words of K per row of Bt in the tile
    constexpr uint32_t LOW = sizeof(T) == 1 ? 0xFFu : 0xFFFFu;
    const int t = threadIdx.y * 32 + threadIdx.x;
    for (int idx = t; idx < TN * WORDS; idx += 256) {
        const int j = idx / WORDS, wq = idx % WORDS;
        if (n0 + j >= Np) continue;
        uint32_t w = 0u;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            w |= ((uint32_t)tile[wq * VEC + e][j] & LOW)
                 << (8 * (int)sizeof(T) * e);
        *reinterpret_cast<uint32_t*>(Bt + (size_t)(n0 + j) * Kp + k0 +
                                     wq * VEC) = w;
    }
}

// B (K, N) -> Bt (Np, Kp), by words where B's rows allow it.
template <typename T>
void launch_transpose(const T* B, T* Bt, int K, int N, int Kp, int Np,
                      cudaStream_t stream) {
    constexpr int TN = 32 * (4 / (int)sizeof(T));
    if (reinterpret_cast<uintptr_t>(B) % 4 == 0 &&
        ((size_t)N * sizeof(T)) % 4 == 0)
        transpose_pad_words<T>
            <<<dim3(Kp / 32, (Np + TN - 1) / TN), dim3(32, 8), 0, stream>>>(
                B, Bt, K, N, Kp, Np);
    else
        transpose_pad<T><<<dim3(Kp / 32, Np / 32), dim3(32, 8), 0, stream>>>(
            B, Bt, K, N, Kp);
}

// One 16-byte chunk of A's tile: row gm, values kb .. kb + 16 / sizeof(T).
template <typename T, bool ALIGNED>
__device__ __forceinline__ uint4 load_a_chunk(const T* __restrict__ A,
                                              long long gm, int kb, int M,
                                              int K) {
    constexpr int PER = 16 / (int)sizeof(T);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gm >= M || kb >= K) return v;
    const T* p = A + (size_t)gm * K + kb;
    if (ALIGNED) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < PER; ++e) {
        if (kb + e < K) {
            const uint32_t bits = p[e];
            w[e * (int)sizeof(T) / 4] |=
                bits << (8 * ((e * (int)sizeof(T)) % 4));
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename P, int BN, bool ALIGNED>
// registers capped so that three blocks (BN = 64) or two (BN = 128) fit an SM
__global__ void __launch_bounds__(THREADS, BN == 64 ? 3 : 2)
matmul_kernel(const typename P::raw_t* __restrict__ A,
              const typename P::raw_t* __restrict__ Bt,
              typename P::out_t* __restrict__ C, int M, int K, int N,
              int Kp) {
    typedef typename P::raw_t raw_t;
    typedef typename P::acc_t acc_t;
    constexpr int BK = TILE_BYTES / (int)sizeof(raw_t);  // values per row
    constexpr int PER = 16 / (int)sizeof(raw_t);          // values per chunk
    constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
    constexpr int WM = BM / WARPS_M;  // the warp's sub-tile is WM x 32
    constexpr int MT = WM / 16, NT = 4;
    constexpr int A_CHUNKS = BM * 4 / THREADS;
    constexpr int B_CHUNKS = BN * 4 / THREADS;

    __shared__ __align__(16) uint32_t As[BM * ROW_WORDS];
    __shared__ __align__(16) uint32_t Bs[BN * ROW_WORDS];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * 32;
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;

    acc_t acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = (acc_t)0;

    uint4 ra[A_CHUNKS], rb[B_CHUNKS];
    const int nk = Kp / BK;

    // the tile at k0 into registers
    auto load_tile = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            const int c = tid + i * THREADS;
            ra[i] = load_a_chunk<raw_t, ALIGNED>(
                A, m0 + (c >> 2), k0 + (c & 3) * PER, M, K);
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            const int c = tid + i * THREADS;
            rb[i] = __ldg(reinterpret_cast<const uint4*>(
                Bt + (size_t)(n0 + (c >> 2)) * Kp + k0 + (c & 3) * PER));
        }
    };
    // the registers into shared memory
    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            const int c = tid + i * THREADS;
            *reinterpret_cast<uint4*>(
                &As[(c >> 2) * ROW_WORDS + (c & 3) * 4]) = ra[i];
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            const int c = tid + i * THREADS;
            *reinterpret_cast<uint4*>(
                &Bs[(c >> 2) * ROW_WORDS + (c & 3) * 4]) = rb[i];
        }
    };

    load_tile(0);
    store_tile();
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
        const bool more = kt + 1 < nk;
        if (more) load_tile((kt + 1) * BK);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // two 32-byte steps of K per tile
            const int w0 = ks * 8 + t;
            uint32_t a[MT][4], b[NT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const uint32_t* p = &As[(wm + i * 16 + g) * ROW_WORDS + w0];
                a[i][0] = p[0];
                a[i][1] = p[8 * ROW_WORDS];
                a[i][2] = p[4];
                a[i][3] = p[8 * ROW_WORDS + 4];
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const uint32_t* p = &Bs[(wn + j * 8 + g) * ROW_WORDS + w0];
                b[j][0] = p[0];
                b[j][1] = p[4];
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) P::mma(acc[i][j], a[i], b[j]);
        }
        __syncthreads();
        if (more) {
            store_tile();
            __syncthreads();
        }
    }

    // a thread holds C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1] of each
    // 16 x 8 tile; pairs go out as one store when N is even
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = n0 + wn + j * 8 + t * 2;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long r = m0 + wm + i * 16 + g + half * 8;
                if (r >= M || c >= N) continue;
                typename P::out_t* p = C + (size_t)r * N + c;
                const acc_t v0 = acc[i][j][half * 2];
                const acc_t v1 = acc[i][j][half * 2 + 1];
                if (pairs) {
                    P::store2(p, v0, v1);
                } else {
                    P::store(p, v0);
                    if (c + 1 < N) P::store(p + 1, v1);
                }
            }
        }
    }
}

template <typename P>
int launch(const void* A, const void* B, void* Bt, void* C, int M, int K,
           int N, int Kp, int Np, int bn, cudaStream_t stream) {
    typedef typename P::raw_t raw_t;
    typedef typename P::out_t out_t;
    const raw_t* a = static_cast<const raw_t*>(A);
    raw_t* bt = static_cast<raw_t*>(Bt);
    out_t* c = static_cast<out_t*>(C);
    launch_transpose<raw_t>(static_cast<const raw_t*>(B), bt, K, N, Kp, Np,
                            stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool aligned = (reinterpret_cast<uintptr_t>(A) % 16 == 0) &&
                         (((size_t)K * sizeof(raw_t)) % 16 == 0);
    const dim3 grid((M + BM - 1) / BM, Np / bn);
    if (bn == 64) {
        if (aligned)
            matmul_kernel<P, 64, true><<<grid, THREADS, 0, stream>>>(
                a, bt, c, M, K, N, Kp);
        else
            matmul_kernel<P, 64, false><<<grid, THREADS, 0, stream>>>(
                a, bt, c, M, K, N, Kp);
    } else {
        if (aligned)
            matmul_kernel<P, 128, true><<<grid, THREADS, 0, stream>>>(
                a, bt, c, M, K, N, Kp);
        else
            matmul_kernel<P, 128, false><<<grid, THREADS, 0, stream>>>(
                a, bt, c, M, K, N, Kp);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// wgmma + TMA + mbarrier ring
// ---------------------------------------------------------------------------
namespace {
namespace hopper {

constexpr int TILE_M = 128;          // rows of C per tile: 64 per consumer warpgroup
constexpr int CONSUMERS = 256;       // threads of the two consumer warpgroups
constexpr int BLOCK = CONSUMERS + 128;
constexpr int SMEM_RING = 196608;    // bytes of shared memory the ring may take

// stages of `stage_bytes` in the ring: as many as fit, at most 8
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
    return SMEM_RING / stage_bytes > 8 ? 8 : SMEM_RING / stage_bytes;
}

template <typename P, int BN> struct Wgmma;

template <> struct Wgmma<Int8, 64> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a,
                                               uint64_t b, int scale_d) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            " %8, %9, %10, %11, %12, %13, %14, %15, "
            " %16, %17, %18, %19, %20, %21, %22, %23, "
            " %24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<Int8, 128> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            " %8, %9, %10, %11, %12, %13, %14, %15, "
            " %16, %17, %18, %19, %20, %21, %22, %23, "
            " %24, %25, %26, %27, %28, %29, %30, %31, "
            " %32, %33, %34, %35, %36, %37, %38, %39, "
            " %40, %41, %42, %43, %44, %45, %46, %47, "
            " %48, %49, %50, %51, %52, %53, %54, %55, "
            " %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<Int8, 256> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(int (&d)[128], uint64_t a,
                                               uint64_t b, int scale_d) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            " %8, %9, %10, %11, %12, %13, %14, %15, "
            " %16, %17, %18, %19, %20, %21, %22, %23, "
            " %24, %25, %26, %27, %28, %29, %30, %31, "
            " %32, %33, %34, %35, %36, %37, %38, %39, "
            " %40, %41, %42, %43, %44, %45, %46, %47, "
            " %48, %49, %50, %51, %52, %53, %54, %55, "
            " %56, %57, %58, %59, %60, %61, %62, %63, "
            " %64, %65, %66, %67, %68, %69, %70, %71, "
            " %72, %73, %74, %75, %76, %77, %78, %79, "
            " %80, %81, %82, %83, %84, %85, %86, %87, "
            " %88, %89, %90, %91, %92, %93, %94, %95, "
            " %96, %97, %98, %99, %100, %101, %102, %103, "
            " %104, %105, %106, %107, %108, %109, %110, %111, "
            " %112, %113, %114, %115, %116, %117, %118, %119, "
            " %120, %121, %122, %123, %124, %125, %126, %127}, "
            "%128, %129, p;\n"
            "}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
              "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
              "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
              "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
              "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
              "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
              "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
              "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
              "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
              "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
              "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
              "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
              "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
              "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
              "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
              "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
              "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <> struct Wgmma<Bf16, 64> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
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
            "%32, %33, p, 1, 1, 0, %35;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(a), "l"(b), "r"(scale_d), "n"((int)B_AS_STORED));
    }
};

template <> struct Wgmma<Bf16, 128> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                               uint64_t b, int scale_d) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            " %8, %9, %10, %11, %12, %13, %14, %15, "
            " %16, %17, %18, %19, %20, %21, %22, %23, "
            " %24, %25, %26, %27, %28, %29, %30, %31, "
            " %32, %33, %34, %35, %36, %37, %38, %39, "
            " %40, %41, %42, %43, %44, %45, %46, %47, "
            " %48, %49, %50, %51, %52, %53, %54, %55, "
            " %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, %67;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d), "n"((int)B_AS_STORED));
    }
};

template <> struct Wgmma<Bf16, 256> {
    template <bool B_AS_STORED>
    static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                               uint64_t b, int scale_d) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            " %8, %9, %10, %11, %12, %13, %14, %15, "
            " %16, %17, %18, %19, %20, %21, %22, %23, "
            " %24, %25, %26, %27, %28, %29, %30, %31, "
            " %32, %33, %34, %35, %36, %37, %38, %39, "
            " %40, %41, %42, %43, %44, %45, %46, %47, "
            " %48, %49, %50, %51, %52, %53, %54, %55, "
            " %56, %57, %58, %59, %60, %61, %62, %63, "
            " %64, %65, %66, %67, %68, %69, %70, %71, "
            " %72, %73, %74, %75, %76, %77, %78, %79, "
            " %80, %81, %82, %83, %84, %85, %86, %87, "
            " %88, %89, %90, %91, %92, %93, %94, %95, "
            " %96, %97, %98, %99, %100, %101, %102, %103, "
            " %104, %105, %106, %107, %108, %109, %110, %111, "
            " %112, %113, %114, %115, %116, %117, %118, %119, "
            " %120, %121, %122, %123, %124, %125, %126, %127}, "
            "%128, %129, p, 1, 1, 0, %131;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
              "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
              "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
              "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "l"(a), "l"(b), "r"(scale_d), "n"((int)B_AS_STORED));
    }
};


// Keeps the compiler from moving a use of a sum across the asynchronous
// products that write it.
__device__ __forceinline__ void pin(int& r) {
    asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void pin(float& r) {
    asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// Shared-memory matrix descriptor: start address >> 4 in bits 0-13, the
// leading offset >> 4 in bits 16-29, the stride offset >> 4 in bits 32-45,
// the swizzle mode in bits 62-63 (1 = 128 bytes, 2 = 64 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int leading,
                                              int stride, int swizzle) {
    uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
    d |= (uint64_t)(leading >> 4) << 16;
    d |= (uint64_t)(stride >> 4) << 32;
    d |= (uint64_t)swizzle << 62;
    return d;
}

// A tile with K contiguous: rows of KS bytes of K written with the KS-byte
// swizzle.  8-row groups lie 8 * KS bytes apart; the leading offset is not
// used.
template <int KS>
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) {
    return smem_desc(addr, 16, 8 * KS, KS == 128 ? 1 : 2);
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
// The four lanes of a quad each hold four 32-bit items; afterwards lane q
// holds item q of lanes 0..3 in that order.  Two rounds of exchanges, with
// the lane two away and with the lane next door.
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
    const bool upper = q & 2, odd = q & 1;
    uint32_t s0 = upper ? a[0] : a[2], s1 = upper ? a[1] : a[3];
    s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
    if (upper) { a[0] = s0; a[1] = s1; } else { a[2] = s0; a[3] = s1; }
    uint32_t t0 = odd ? a[0] : a[1], t1 = odd ? a[2] : a[3];
    t0 = __shfl_xor_sync(0xffffffffu, t0, 1);
    t1 = __shfl_xor_sync(0xffffffffu, t1, 1);
    if (odd) { a[0] = t0; a[2] = t1; } else { a[1] = t0; a[3] = t1; }
}

// One row's results in a group of four 8-column blocks: v[i] is this lane's
// pair (columns 2q, 2q + 1 of block i); `row` points at the group's first
// column in that row and is 32-byte aligned.  Every lane of the warp must
// call it; `ok` says whether this lane's row exists.
//
// bfloat16: a pair is 4 bytes, so the quad trades pairs until lane q holds
// the 8 results of block q and stores them as 16 bytes: the warp then writes
// whole 32-byte sectors.
__device__ __forceinline__ void store_group(__nv_bfloat16* row,
                                            const float (&v)[4][2], int q,
                                            bool ok) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[i][0], v[i][1]);
        a[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    quad_transpose(a, q);
    if (ok)
        *reinterpret_cast<uint4*>(row + q * 8) =
            make_uint4(a[0], a[1], a[2], a[3]);
}
// 32-bit results: a pair is 8 bytes and the quad's four pairs fill a sector
// as they are.
__device__ __forceinline__ void store_group(float* row, const float (&v)[4][2],
                                            int q, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float2*>(row + i * 8 + q * 2) =
            make_float2(v[i][0], v[i][1]);
}
__device__ __forceinline__ void store_group(int* row, const int (&v)[4][2],
                                            int q, bool ok) {
    if (!ok) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        *reinterpret_cast<int2*>(row + i * 8 + q * 2) =
            make_int2(v[i][0], v[i][1]);
}

// What the kernel needs beside the two tensor maps.  For a product: C (M, N).
// For the convolution: out (B, H, W, O) with M = B * H * W and N = O, scale
// (B, O) and bias (O,) float32, C channels a pixel.
struct Params {
    void* out;
    const float* scale;
    const float* bias;
    long long M;
    int N;
    int H, W, C;
    int m_tiles, n_tiles;
    int tiles_per_row;   // convolution: tiles of 128 pixels along W
    int k_slices;        // ring stages per tile
    int stages;          // RES: stages of A that fit beside the weights
};

// PRODUCT: A (M, K) and Bt (N, K), both with K contiguous.  PRODUCT_BN (bf16
// only): B as it is stored, (K, N) with N contiguous, read by wgmma as the
// transposed operand, so no Bt is written.  CONV_*: the 3x3 convolution.
enum Mode { PRODUCT = 0, PRODUCT_BN = 1, CONV_F32 = 2, CONV_BF16 = 3 };

// the convolution's result type
template <int MODE> struct OutOf { typedef float type; };
template <> struct OutOf<CONV_BF16> { typedef __nv_bfloat16 type; };

// One ring stage holds SUB sub-tiles of A (128 rows x KS bytes of K each) and
// as many of B (BN rows): 1 for a product; 3 for the convolution, the taps
// dy = -1, 0, 1 of one dx and one chunk of KS channels, which one box of
// three image rows brings in.
//
// RES (convolution only): the weights of all taps stay in shared memory for
// the block's lifetime, loaded once, and the ring's stages hold A alone.
template <typename P, int BN, int KS, int MODE, bool RES>
__global__ void __launch_bounds__(BLOCK, 1)
ring_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, const Params p) {
    typedef typename P::acc_t acc_t;
    constexpr bool CONV = MODE == CONV_F32 || MODE == CONV_BF16;
    constexpr int SUB = CONV ? 3 : 1;
    constexpr int A_BYTES = TILE_M * KS, B_BYTES = BN * KS;
    constexpr int STAGE_BYTES = SUB * (A_BYTES + (RES ? 0 : B_BYTES));
    constexpr int STAGES = ring_stages(STAGE_BYTES);
    constexpr int KSTEPS = KS / 32;       // wgmma steps of 32 bytes of K
    constexpr int EL = (int)sizeof(typename P::raw_t);
    // PRODUCT_BN: B arrives in chunks of 64 columns, each KS / EL rows of K
    // by 128 bytes of N
    constexpr int BN_CHUNK = (KS / EL) * 128;

    extern __shared__ uint8_t ring_raw[];
    __shared__ __align__(8) uint64_t full_bar[STAGES];
    __shared__ __align__(8) uint64_t empty_bar[STAGES];
    __shared__ __align__(8) uint64_t weights_bar;
    // swizzled tiles repeat every 1024 bytes of address
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(ring_raw) + 1023) & ~(uintptr_t)1023);
    // RES: the weights first, SUB * B_BYTES per slice of a tile, then the ring
    const int weights_bytes = RES ? p.k_slices * SUB * B_BYTES : 0;
    uint8_t* ring = smem + weights_bytes;
    const int stages = RES ? p.stages : STAGES;

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full_bar[s], 1);
            mbar_init(&empty_bar[s], CONSUMERS / 32);
        }
        mbar_init(&weights_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int n_tiles_total = p.m_tiles * p.n_tiles;

    if (tid >= CONSUMERS) {
        // ---- producer warpgroup: one thread starts every load -------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == CONSUMERS) {
            int stage = 0;
            uint32_t phase = 1;   // the ring starts empty: the first waits pass
            const int chunks = CONV ? p.C / KS : 1;   // channel chunks per tap
            if (RES) {
                mbar_expect_tx(&weights_bar, weights_bytes);
                for (int s = 0; s < p.k_slices; ++s)
                    tma_load_3d(smem + s * SUB * B_BYTES, &map_b, &weights_bar,
                                (s % chunks) * KS, 0, (s / chunks) * 3);
            }
            for (int tile = blockIdx.x; tile < n_tiles_total;
                 tile += gridDim.x) {
                const int mt = tile / p.n_tiles, nt = tile % p.n_tiles;
                int x0 = 0, y = 0, b = 0;
                if (CONV) {
                    const int row = mt / p.tiles_per_row;
                    x0 = (mt % p.tiles_per_row) * TILE_M;
                    y = row % p.H;
                    b = row / p.H;
                }
                int dx = 0, chunk = 0;
                for (int s = 0; s < p.k_slices; ++s) {
                    mbar_wait(&empty_bar[stage], phase);
                    mbar_expect_tx(&full_bar[stage], STAGE_BYTES);
                    uint8_t* a_dst = ring + stage * STAGE_BYTES;
                    uint8_t* b_dst = a_dst + SUB * A_BYTES;
                    if (CONV) {
                        // image rows y - 1 .. y + 1 at the columns of tap dx;
                        // the weights of the same three taps
                        tma_load_4d(a_dst, &map_a, &full_bar[stage],
                                    chunk * KS, x0 + dx - 1, y - 1, b);
                        if (!RES)
                            tma_load_3d(b_dst, &map_b, &full_bar[stage],
                                        chunk * KS, nt * BN, dx * 3);
                        if (++chunk == chunks) {
                            chunk = 0;
                            ++dx;
                        }
                    } else {
                        tma_load_2d(a_dst, &map_a, &full_bar[stage],
                                    s * (KS / EL), mt * TILE_M);
                        if (MODE == PRODUCT) {
                            tma_load_2d(b_dst, &map_b, &full_bar[stage],
                                        s * (KS / EL), nt * BN);
                        } else {
#pragma unroll
                            for (int j = 0; j < BN / 64; ++j)
                                tma_load_2d(b_dst + j * BN_CHUNK, &map_b,
                                            &full_bar[stage],
                                            nt * BN + j * 64, s * (KS / EL));
                        }
                    }
                    if (++stage == stages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- two consumer warpgroups: 64 rows of the tile each ------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
        const int g = lane >> 2, q = lane & 3;
        const uint32_t ring_addr = smem_u32(ring);
        int stage = 0;
        uint32_t phase = 0;
        acc_t acc[BN / 2];
        if (RES) mbar_wait(&weights_bar, 0);

        for (int tile = blockIdx.x; tile < n_tiles_total; tile += gridDim.x) {
            const int mt = tile / p.n_tiles, nt = tile % p.n_tiles;
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = (acc_t)0;
            int prev = -1;
            for (int s = 0; s < p.k_slices; ++s) {
                mbar_wait(&full_bar[stage], phase);
                const uint32_t a_addr =
                    ring_addr + stage * STAGE_BYTES + wg * 64 * KS;
                const uint32_t b_addr =
                    RES ? smem_u32(smem) + s * SUB * B_BYTES
                        : ring_addr + stage * STAGE_BYTES + SUB * A_BYTES;
                const uint64_t da = k_major_desc<KS>(a_addr);
                // B as stored: rows of K are 128 bytes of N, 8 of them 1024
                // bytes; the next 64 columns lie one chunk further
                const uint64_t db =
                    MODE == PRODUCT_BN ? smem_desc(b_addr, BN_CHUNK, 1024, 1)
                                       : k_major_desc<KS>(b_addr);
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                for (int t = 0; t < SUB; ++t)
#pragma unroll
                    for (int k = 0; k < KSTEPS; ++k)
                        Wgmma<P, BN>::template mma<MODE == PRODUCT_BN>(
                            acc, da + (t * A_BYTES >> 4) + 2 * k,
                            db + (t * B_BYTES >> 4) +
                                (MODE == PRODUCT_BN ? 128 : 2) * k,
                            (s | t | k) != 0);
                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                // the group before this one has read its stage: hand it back
                asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
                if (prev >= 0 && lane == 0) mbar_arrive(&empty_bar[prev]);
                prev = stage;
                if (++stage == stages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
            if (prev >= 0 && lane == 0) mbar_arrive(&empty_bar[prev]);

            // A thread holds, of each 8-column block j, the columns 2q and
            // 2q + 1 of the rows g and g + 8 of its warp's 16 rows.  Tiles
            // whose columns all exist, in rows of a multiple of 8 results,
            // take the first branch: the quad trades its pairs so that each
            // lane stores 8 neighbouring results of a row at once.
            const int r_in_tile = wg * 64 + warp * 16 + g;
            const int n0 = nt * BN;
            const bool whole = n0 + BN <= p.N && (p.N & 7) == 0;
            if (!CONV) {
                typedef typename P::out_t out_t;
                const long long r0 = (long long)mt * TILE_M + r_in_tile;
                out_t* row0 =
                    static_cast<out_t*>(p.out) + (size_t)r0 * p.N + n0;
                out_t* row1 = row0 + (size_t)8 * p.N;
                if (whole) {
                    const bool ok0 = r0 < p.M, ok1 = r0 + 8 < p.M;
#pragma unroll
                    for (int m = 0; m < BN / 32; ++m) {
                        acc_t v[4][2], u[4][2];   // rows g and g + 8
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            v[i][0] = acc[(m * 4 + i) * 4];
                            v[i][1] = acc[(m * 4 + i) * 4 + 1];
                            u[i][0] = acc[(m * 4 + i) * 4 + 2];
                            u[i][1] = acc[(m * 4 + i) * 4 + 3];
                        }
                        store_group(row0 + m * 32, v, q, ok0);
                        store_group(row1 + m * 32, u, q, ok1);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
                        const int c = n0 + j * 8 + q * 2;
#pragma unroll
                        for (int half = 0; half < 2; ++half) {
                            if (r0 + half * 8 >= p.M || c >= p.N) continue;
                            out_t* dst = (half ? row1 : row0) + j * 8 + q * 2;
                            P::store(dst, acc[j * 4 + half * 2]);
                            if (c + 1 < p.N)
                                P::store(dst + 1, acc[j * 4 + half * 2 + 1]);
                        }
                    }
                }
            } else {
                typedef typename OutOf<MODE>::type out_t;
                const int row = mt / p.tiles_per_row;   // b * H + y
                const int x = (mt % p.tiles_per_row) * TILE_M + r_in_tile;
                const bool ok0 = x < p.W, ok1 = x + 8 < p.W;
                const float* scale =
                    p.scale + (size_t)(row / p.H) * p.N + n0 + q * 2;
                const float* bias = p.bias + n0 + q * 2;
                out_t* row0 = static_cast<out_t*>(p.out) +
                              ((size_t)row * p.W + x) * p.N + n0;
                out_t* row1 = row0 + (size_t)8 * p.N;
                // float(sum) * scale + bias: two roundings, a multiply and an
                // add in float32
                if (whole) {
#pragma unroll
                    for (int m = 0; m < BN / 32; ++m) {
                        float v[4][2], u[4][2];   // rows g and g + 8
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int j = m * 4 + i;
                            const float2 sc = __ldg(
                                reinterpret_cast<const float2*>(scale + j * 8));
                            const float2 bi = __ldg(
                                reinterpret_cast<const float2*>(bias + j * 8));
                            v[i][0] = __fadd_rn(
                                __fmul_rn((float)acc[j * 4], sc.x), bi.x);
                            v[i][1] = __fadd_rn(
                                __fmul_rn((float)acc[j * 4 + 1], sc.y), bi.y);
                            u[i][0] = __fadd_rn(
                                __fmul_rn((float)acc[j * 4 + 2], sc.x), bi.x);
                            u[i][1] = __fadd_rn(
                                __fmul_rn((float)acc[j * 4 + 3], sc.y), bi.y);
                        }
                        store_group(row0 + m * 32, v, q, ok0);
                        store_group(row1 + m * 32, u, q, ok1);
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            if (n0 + j * 8 + q * 2 + e >= p.N) continue;
                            const float sc = __ldg(scale + j * 8 + e);
                            const float bi = __ldg(bias + j * 8 + e);
                            if (ok0)
                                store_one(row0 + j * 8 + q * 2 + e,
                                          __fadd_rn(__fmul_rn(
                                              (float)acc[j * 4 + e], sc), bi));
                            if (ok1)
                                store_one(
                                    row1 + j * 8 + q * 2 + e,
                                    __fadd_rn(__fmul_rn(
                                        (float)acc[j * 4 + 2 + e], sc), bi));
                        }
                    }
                }
            }
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1 (the CUDA runtime has
// loaded it into the process already), so nothing links against it
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
        if (lib != nullptr)
            fn = reinterpret_cast<EncodeTiled>(
                dlsym(lib, "cuTensorMapEncodeTiled"));
    }
    return fn;
}

constexpr int ENCODE_FAILED = 100000;   // + the CUresult of the encoding

// A tensor map over `rank` dimensions (innermost first); dims and box in
// elements, strides in bytes for dimensions 1 .. rank - 1; the swizzle is
// `ks` (128 or 64) bytes wide.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
             const void* base, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box, int ks) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return ENCODE_FAILED;
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    CUresult r = encode(
        map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
        ks == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// SMs of the current device, asked once per device
int sm_count() {
    static int counts[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    int& n = counts[dev & 63];
    if (n == 0)
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
}

template <typename P, int BN, int KS, int MODE, bool RES = false>
int launch_ring(const CUtensorMap& map_a, const CUtensorMap& map_b,
                const Params& p, cudaStream_t stream) {
    constexpr int SUB = MODE == CONV_F32 || MODE == CONV_BF16 ? 3 : 1;
    constexpr int STAGE_BYTES = SUB * (TILE_M + (RES ? 0 : BN)) * KS;
    // RES: the whole budget, weights and ring together
    constexpr int SMEM =
        (RES ? SMEM_RING : ring_stages(STAGE_BYTES) * STAGE_BYTES) + 1024;
    auto kernel = ring_kernel<P, BN, KS, MODE, RES>;
    // once per instantiation and device
    static unsigned long long sized = 0ull;
    int dev = 0;
    cudaGetDevice(&dev);
    if (!(sized >> (dev & 63) & 1ull)) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err != cudaSuccess) return (int)err;
        sized |= 1ull << (dev & 63);
    }
    // one persistent block per SM
    const int tiles = p.m_tiles * p.n_tiles, sms = sm_count();
    kernel<<<tiles < sms ? tiles : sms, BLOCK, SMEM, stream>>>(map_a, map_b,
                                                               p);
    return (int)cudaGetLastError();
}

template <typename P, int KS, int MODE>
int launch_bn(int bn, const CUtensorMap& map_a, const CUtensorMap& map_b,
              const Params& p, cudaStream_t stream) {
    if (bn == 64) return launch_ring<P, 64, KS, MODE>(map_a, map_b, p, stream);
    if (bn == 128)
        return launch_ring<P, 128, KS, MODE>(map_a, map_b, p, stream);
    return launch_ring<P, 256, KS, MODE>(map_a, map_b, p, stream);
}

// C = A x B through the ring.  Bt == nullptr (bf16 only): B's rows are
// 16-byte aligned and wgmma reads B as it is stored.
template <typename P>
int product(const void* A, const void* B, void* Bt, void* C, int M, int K,
            int N, int Kp, int Np, int bn, cudaStream_t stream) {
    typedef typename P::raw_t raw_t;
    constexpr int KS = 128, EL = (int)sizeof(raw_t);
    const CUtensorMapDataType type = EL == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    alignas(64) CUtensorMap map_a, map_b;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * EL};
    const cuuint32_t box[2] = {(cuuint32_t)(KS / EL), (cuuint32_t)TILE_M};
    int rc = make_map(&map_a, type, 2, A, dims, strides, box, KS);
    if (rc) return rc;

    Params p = {};
    p.out = C;
    p.M = M;
    p.N = N;
    p.m_tiles = (M + TILE_M - 1) / TILE_M;
    p.n_tiles = Np / bn;
    p.k_slices = Kp * EL / KS;

    if (Bt == nullptr) {
        if (EL != 2) return (int)cudaErrorInvalidValue;   // int8 needs Bt
        // B (K, N): boxes of 64 columns (128 bytes) by KS / EL rows of K
        const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
        const cuuint64_t b_strides[1] = {(cuuint64_t)N * EL};
        const cuuint32_t b_box[2] = {64, (cuuint32_t)(KS / EL)};
        rc = make_map(&map_b, type, 2, B, b_dims, b_strides, b_box, 128);
        if (rc) return rc;
        return launch_bn<P, KS, EL == 2 ? PRODUCT_BN : PRODUCT>(
            bn, map_a, map_b, p, stream);
    }
    raw_t* bt = static_cast<raw_t*>(Bt);
    launch_transpose<raw_t>(static_cast<const raw_t*>(B), bt, K, N, Kp, Np,
                            stream);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // Bt (Np, Kp), K contiguous: boxes of KS bytes of K by bn rows
    const cuuint64_t b_dims[2] = {(cuuint64_t)Kp, (cuuint64_t)Np};
    const cuuint64_t b_strides[1] = {(cuuint64_t)Kp * EL};
    const cuuint32_t b_box[2] = {(cuuint32_t)(KS / EL), (cuuint32_t)bn};
    rc = make_map(&map_b, type, 2, bt, b_dims, b_strides, b_box, KS);
    if (rc) return rc;
    return launch_bn<P, KS, PRODUCT>(bn, map_a, map_b, p, stream);
}

// Bt[n][(dx * 3 + dy) * C + c] = w_q[((dy * 3 + dx) * C + c)][n], zero for
// n >= O: the weights with K contiguous and the taps of one dx together, as
// the ring's stages take them.
__global__ void conv_weights(const int8_t* __restrict__ w_q,
                             int8_t* __restrict__ bt, int C, int O, int Np) {
    const int K = 9 * C;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= Np * K) return;
    const int n = i / K, k = i % K;
    const int tap = k / C, c = k % C;          // tap = dx * 3 + dy
    const int src = ((tap % 3) * 3 + tap / 3) * C + c;
    bt[i] = n < O ? w_q[(size_t)src * O + n] : (int8_t)0;
}

int conv(const void* x_q, const void* w_q, void* Bt, const void* scale,
         const void* bias, void* out, int B, int H, int W, int C, int O,
         int Np, int bn, int out_bf16, cudaStream_t stream) {
    constexpr int KS = 64;
    int8_t* bt = static_cast<int8_t*>(Bt);
    const int n_w = Np * 9 * C;
    conv_weights<<<(n_w + 255) / 256, 256, 0, stream>>>(
        static_cast<const int8_t*>(w_q), bt, C, O, Np);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    alignas(64) CUtensorMap map_a, map_b;
    // x_q (B, H, W, C): a box of KS channels x 128 pixels x 3 image rows
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                   (cuuint64_t)H * W * C};
    const cuuint32_t box[4] = {(cuuint32_t)KS, (cuuint32_t)TILE_M, 3, 1};
    int rc = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, x_q, dims,
                      strides, box, KS);
    if (rc) return rc;
    // Bt as (channel, output channel, tap): a box of KS channels x bn output
    // channels x the 3 taps of one dx
    const cuuint64_t b_dims[3] = {(cuuint64_t)C, (cuuint64_t)Np, 9};
    const cuuint64_t b_strides[2] = {(cuuint64_t)9 * C, (cuuint64_t)C};
    const cuuint32_t b_box[3] = {(cuuint32_t)KS, (cuuint32_t)bn, 3};
    rc = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, bt, b_dims,
                  b_strides, b_box, KS);
    if (rc) return rc;

    Params p = {};
    p.out = out;
    p.scale = static_cast<const float*>(scale);
    p.bias = static_cast<const float*>(bias);
    p.M = (long long)B * H * W;
    p.N = O;
    p.H = H;
    p.W = W;
    p.C = C;
    p.tiles_per_row = (W + TILE_M - 1) / TILE_M;
    p.m_tiles = B * H * p.tiles_per_row;
    p.n_tiles = Np / bn;
    p.k_slices = 3 * (C / KS);
    // weights that leave room for 4 stages of A stay in shared memory
    const int a_stage = 3 * TILE_M * KS;
    const int room = SMEM_RING - 9 * C * bn;
    if (bn <= 128 && room >= 4 * a_stage) {
        p.stages = room / a_stage > 8 ? 8 : room / a_stage;
        if (bn == 64)
            return out_bf16 ? launch_ring<Int8, 64, KS, CONV_BF16, true>(
                                  map_a, map_b, p, stream)
                            : launch_ring<Int8, 64, KS, CONV_F32, true>(
                                  map_a, map_b, p, stream);
        return out_bf16 ? launch_ring<Int8, 128, KS, CONV_BF16, true>(
                              map_a, map_b, p, stream)
                        : launch_ring<Int8, 128, KS, CONV_F32, true>(
                              map_a, map_b, p, stream);
    }
    if (out_bf16)
        return launch_bn<Int8, KS, CONV_BF16>(bn, map_a, map_b, p, stream);
    return launch_bn<Int8, KS, CONV_F32>(bn, map_a, map_b, p, stream);
}

}  // namespace hopper
}  // namespace

// A (M, K) and B (K, N) int8 row-major -> C (M, N) int32.  Bt is scratch of
// Np x Kp bytes; Kp is K rounded up to 64, Np is N rounded up to bn (64 or
// 128).  Returns cudaGetLastError() of the launches.
extern "C" int matmul_int8_launch(const void* A, const void* B, void* Bt,
                                  void* C, int M, int K, int N, int Kp,
                                  int Np, int bn, cudaStream_t stream) {
    return launch<Int8>(A, B, Bt, C, M, K, N, Kp, Np, bn, stream);
}

// The same for bf16 operands and a bf16 result (f32 sums); Kp is K rounded
// up to 32 and Bt holds Np x Kp bf16 values.
extern "C" int matmul_bf16_launch(const void* A, const void* B, void* Bt,
                                  void* C, int M, int K, int N, int Kp,
                                  int Np, int bn, cudaStream_t stream) {
    return launch<Bf16>(A, B, Bt, C, M, K, N, Kp, Np, bn, stream);
}

// The same two products through the wgmma kernel.  A's rows must be 16-byte
// aligned (A's address and K * element size multiples of 16).  Bt is scratch
// of Np x Kp values; Kp is K rounded up to 128 bytes of values, Np is N
// rounded up to bn (64, 128 or 256).  The bf16 entry takes Bt == NULL when
// B's rows are 16-byte aligned too, and then reads B as it is stored.
extern "C" int matmul_int8_tma_launch(const void* A, const void* B, void* Bt,
                                      void* C, int M, int K, int N, int Kp,
                                      int Np, int bn, cudaStream_t stream) {
    return hopper::product<Int8>(A, B, Bt, C, M, K, N, Kp, Np, bn, stream);
}

extern "C" int matmul_bf16_tma_launch(const void* A, const void* B, void* Bt,
                                      void* C, int M, int K, int N, int Kp,
                                      int Np, int bn, cudaStream_t stream) {
    return hopper::product<Bf16>(A, B, Bt, C, M, K, N, Kp, Np, bn, stream);
}

// 3x3 convolution, zero padding 1, of x_q (B, H, W, C) int8 with w_q
// (9 * C, O) int8 in tap order (dy, dx, c): out[b, y, x, o] = float(sum) *
// scale[b, o] + bias[o], float32 or (out_bf16) bfloat16, (B, H, W, O).  C must
// be a multiple of 64 and x_q 16-byte aligned.  Bt is scratch of Np x 9 * C
// bytes, Np being O rounded up to bn (64, 128 or 256).
extern "C" int conv3x3_int8_launch(const void* x_q, const void* w_q, void* Bt,
                                   const void* scale, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int O, int Np, int bn, int out_bf16,
                                   cudaStream_t stream) {
    return hopper::conv(x_q, w_q, Bt, scale, bias, out, B, H, W, C, O, Np, bn,
                        out_bf16, stream);
}
