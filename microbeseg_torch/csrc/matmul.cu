// Kernel K5: tiled tensor-core matrix product C = A x B for Hopper.
//
// Replaces microbeseg_tpu's scripts/bench_pallas_int8_dot.py::make_matmul
// (kernel `matmul_kernel`): a product tiled over (M/bm, N/bn, K/bk) whose
// accumulator stays in fast memory across the K steps.  Two entries:
//
//   matmul_int8_launch  int8 x int8 -> int32 (exact)
//   matmul_bf16_launch  bf16 x bf16 -> f32 accumulate -> bf16 (round to
//                       nearest even at the end)
//
// A is (M, K) row-major, B is (K, N) row-major, C is (M, N) row-major, for
// any M, K, N (the TPU kernel needs each divisible by its block).
//
// What bounds it on this card: on the int8 inference path M is 2^19..2^21,
// K is 576..2304 and N is 64 or 128, so A is hundreds of megabytes, B a few
// hundred kilobytes, and the product is bound by the bytes of A and C, not
// by the tensor cores; at 2048^3 the operations bound it.  The design:
//
// - The TPU grid's sequential K dimension becomes a loop inside the block;
//   a block owns a 128 x BN tile of C (BN = 64 or 128) and keeps its sums in
//   registers, so C is written once and A is read once per column block.
// - A first small kernel writes B transposed and zero-padded, Bt (Np, Kp)
//   with K contiguous, so both operands reach shared memory with 16-byte
//   loads and the B fragments of `mma.sync ... row.col` are single 32-bit
//   shared loads.  Bt is a few hundred kilobytes and stays in L2.
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
//   (K * element size not a multiple of 16) the A tile is gathered value by
//   value instead of with 16-byte loads.
//
// No wgmma, no TMA and no multi-stage ring yet: the simple form first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
    transpose_pad<raw_t><<<dim3(Kp / 32, Np / 32), dim3(32, 8), 0, stream>>>(
        static_cast<const raw_t*>(B), bt, K, N, Kp);
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
