// K6 — grouped matrix product over expert-sorted rows (ragged_dot):
//   out[r, :] = lhs[r, :] @ rhs[g(r)]   for the rows r of group g,
// where group g holds the group_sizes[g] rows after those of groups < g;
// rows past sum(group_sizes) are zero, and a group that runs past row M is
// cut there (a negative size counts as 0). lhs [M, K], rhs [G, K, N],
// out [M, N], float32 or bfloat16 in and out, float32 accumulation.
//
// Replaces XLA's jax.lax.ragged_dot in moe_ragged
// (src/repro/models/moe.py:81-83); the reference has no Pallas kernel for
// it. The group sizes are read on the device: the wrapper launches an upper
// bound of row tiles and never syncs the host on them.
//
// What bounds it on the H100: at the MoE shapes (M = tokens x top-k of a
// few thousand, K and N of 768 to 5120, 128 to 160 groups) each group's
// rhs is read once or twice and holds most of the bytes: about 0.4 GB for
// qwen3-moe's expert up-projection, 127 us at 3.35 TB/s, against 13 us of
// bf16 tensor-core work. So bytes, and the design streams each group's rhs
// through shared memory once per row tile of that group.
//
// Design (a simple first kernel; wgmma and TMA are later work):
//   * A CTA owns one BM x BN output tile. Row tiles never straddle two
//     groups: group g has ceil(rows_g / BM) of them, in group order, then
//     the zero rows past the sum get theirs. Tile counts add up to at most
//     ceil(M / BM) + G + 1, which is what the launcher launches; a CTA past
//     the real count exits. Warp 0 of each CTA finds its tile by a warp
//     scan over the group sizes, 32 groups at a time (find_tile).
//   * bfloat16: 4 warps, each a 32 x 32 quarter of a 64 x 64 tile as 2 x 2
//     WMMA 16x16x16 bf16 products with float32 accumulators (mma.sync on
//     the tensor cores); 64 x 32 lhs and 32 x 64 rhs tiles in shared
//     memory, loaded 16 bytes a thread where K and N are multiples of 8.
//     The accumulators go through shared memory and are rounded to bf16
//     once (round to nearest even).
//   * float32: 256 threads, a 4 x 4 micro-tile each, 64 x 16 lhs and
//     16 x 64 rhs tiles in shared memory; each output is a chain of fmaf
//     over k = 0 .. K - 1 in order (no TF32), so it is deterministic.
//   * Offsets into rhs are 64-bit: deepseek-v2's G x K x N is 1.26 G
//     elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Tile {
    int group;  // -1: zero rows past the sum
    int row0;   // first row; row0 >= row1: past the real tiles, exit
    int row1;   // one past the last row
};

__device__ __forceinline__ long long warp_incl_scan(long long v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Warp 0 only: which group and rows row tile `tile` covers.
__device__ void find_tile(const int* __restrict__ gs, int G, int M, int tile,
                          Tile* out) {
    const int lane = threadIdx.x & 31;
    long long row_base = 0;   // rows of the groups before this chunk
    long long tile_base = 0;  // row tiles of the groups before this chunk
    for (int base = 0; base < G; base += 32) {
        const int g = base + lane;
        const long long size = g < G ? max(__ldg(gs + g), 0) : 0;
        const long long incl = warp_incl_scan(size, lane);
        const long long start = row_base + incl - size;
        const long long s_c = min(start, (long long)M);
        const long long e_c = min(start + size, (long long)M);
        const long long tiles = (e_c - s_c + BM - 1) / BM;
        const long long t_incl = warp_incl_scan(tiles, lane);
        const long long t_start = tile_base + t_incl - tiles;
        const bool mine = tile >= t_start && tile < t_start + tiles;
        if (mine) {
            const long long r0 = s_c + (tile - t_start) * BM;
            out->group = g;
            out->row0 = (int)r0;
            out->row1 = (int)min(r0 + BM, e_c);
        }
        if (__ballot_sync(kFull, mine)) return;
        row_base += __shfl_sync(kFull, incl, 31);
        tile_base += __shfl_sync(kFull, t_incl, 31);
    }
    if (lane == 0) {  // the zero rows past the sum
        const long long r0 =
            min(row_base, (long long)M) + (tile - tile_base) * BM;
        out->group = -1;
        out->row0 = (int)min(r0, (long long)M);
        out->row1 = (int)min(r0 + BM, (long long)M);
    }
}

template <typename T>
__device__ void zero_rows(T* __restrict__ out, int row0, int row1, int n0,
                          int N) {
    for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
        const int row = row0 + e / BN, col = n0 + e % BN;
        if (row < row1 && col < N) out[(size_t)row * N + col] = T(0.0f);
    }
}

// ---------------------------------------------------------------- bfloat16

constexpr int BK16 = 32;
constexpr int LDA16 = BK16 + 8;  // 80-byte rows: 16-byte vectors, 32-byte
constexpr int LDB16 = BN + 8;    // aligned WMMA fragments
constexpr int LDC = BN + 4;

template <bool VEC>
__global__ void __launch_bounds__(128) ragged_dot_bf16_kernel(
    const __nv_bfloat16* __restrict__ lhs,  // [M, K]
    const __nv_bfloat16* __restrict__ rhs,  // [G, K, N]
    const int* __restrict__ gs,             // [G]
    __nv_bfloat16* __restrict__ out,        // [M, N]
    int M, int K, int N, int G) {
    using namespace nvcuda;
    __shared__ Tile tile;
    __shared__ __align__(32) __nv_bfloat16 As[BM * LDA16];
    __shared__ __align__(32) __nv_bfloat16 Bs[BK16 * LDB16];
    __shared__ __align__(32) float Cs[BM * LDC];
    if (threadIdx.x < 32) find_tile(gs, G, M, blockIdx.x, &tile);
    __syncthreads();
    const int row0 = tile.row0, row1 = tile.row1, g = tile.group;
    if (row0 >= row1) return;
    const int n0 = blockIdx.y * BN;
    if (g < 0) {
        zero_rows(out, row0, row1, n0, N);
        return;
    }
    const __nv_bfloat16* B = rhs + (size_t)g * K * N;
    const __nv_bfloat16 zero = __float2bfloat16(0.0f);
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < K; k0 += BK16) {
        // lhs tile: BM x BK16 in chunks of 8
        for (int c = threadIdx.x; c < BM * BK16 / 8; c += 128) {
            const int r = c / (BK16 / 8), kc = (c % (BK16 / 8)) * 8;
            const int row = row0 + r, kk = k0 + kc;
            __nv_bfloat16* dst = As + r * LDA16 + kc;
            const __nv_bfloat16* src = lhs + (size_t)row * K + kk;
            if (VEC) {
                uint4 v = make_uint4(0, 0, 0, 0);
                if (row < row1 && kk < K)
                    v = *reinterpret_cast<const uint4*>(src);
                *reinterpret_cast<uint4*>(dst) = v;
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    dst[e] = row < row1 && kk + e < K ? src[e] : zero;
            }
        }
        // rhs tile: BK16 x BN in chunks of 8
        for (int c = threadIdx.x; c < BK16 * BN / 8; c += 128) {
            const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
            const int kk = k0 + r, col = n0 + nc;
            __nv_bfloat16* dst = Bs + r * LDB16 + nc;
            const __nv_bfloat16* src = B + (size_t)kk * N + col;
            if (VEC) {
                uint4 v = make_uint4(0, 0, 0, 0);
                if (kk < K && col < N)
                    v = *reinterpret_cast<const uint4*>(src);
                *reinterpret_cast<uint4*>(dst) = v;
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    dst[e] = kk < K && col + e < N ? src[e] : zero;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK16; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDA16 + kk,
                                       LDA16);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], Bs + kk * LDB16 + wn + j * 16,
                                       LDB16);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                                    acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += 128) {
        const int r = e / BN, c = e % BN;
        const int row = row0 + r, col = n0 + c;
        if (row < row1 && col < N)
            out[(size_t)row * N + col] = __float2bfloat16_rn(Cs[r * LDC + c]);
    }
}

// ----------------------------------------------------------------- float32

constexpr int BK32 = 16;

template <bool VEC>
__global__ void __launch_bounds__(256) ragged_dot_f32_kernel(
    const float* __restrict__ lhs,  // [M, K]
    const float* __restrict__ rhs,  // [G, K, N]
    const int* __restrict__ gs,     // [G]
    float* __restrict__ out,        // [M, N]
    int M, int K, int N, int G) {
    __shared__ Tile tile;
    __shared__ __align__(16) float As[BK32][BM + 4];  // transposed: [k][m]
    __shared__ __align__(16) float Bs[BK32][BN + 4];
    if (threadIdx.x < 32) find_tile(gs, G, M, blockIdx.x, &tile);
    __syncthreads();
    const int row0 = tile.row0, row1 = tile.row1, g = tile.group;
    if (row0 >= row1) return;
    const int n0 = blockIdx.y * BN;
    if (g < 0) {
        zero_rows(out, row0, row1, n0, N);
        return;
    }
    const float* B = rhs + (size_t)g * K * N;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK32) {
        {  // lhs tile: BM x BK32, 4 along k per thread
            const int r = threadIdx.x >> 2, kc = (threadIdx.x & 3) * 4;
            const int row = row0 + r, kk = k0 + kc;
            const float* src = lhs + (size_t)row * K + kk;
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (VEC) {
                if (row < row1 && kk < K) {
                    const float4 f = *reinterpret_cast<const float4*>(src);
                    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (row < row1 && kk + q < K) v[q] = src[q];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) As[kc + q][r] = v[q];
        }
        {  // rhs tile: BK32 x BN, 4 along n per thread
            const int r = threadIdx.x >> 4, nc = (threadIdx.x & 15) * 4;
            const int kk = k0 + r, col = n0 + nc;
            const float* src = B + (size_t)kk * N + col;
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (VEC) {
                if (kk < K && col < N) {
                    const float4 f = *reinterpret_cast<const float4*>(src);
                    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (kk < K && col + q < N) v[q] = src[q];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) Bs[r][nc + q] = v[q];
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK32; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty * 4 + i;
        if (row >= row1) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (col < N) out[(size_t)row * N + col] = acc[i][j];
        }
    }
}

}  // namespace

// bf16: 1 for bfloat16, 0 for float32. vec: K and N are multiples of the
// 16-byte vector (8 bf16 or 4 float32) and lhs and rhs are 16-byte aligned.
extern "C" int ragged_dot_launch(
    const void* lhs, const void* rhs, const void* group_sizes, void* out,
    int m, int k, int n, int g, int bf16, int vec, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    if (k < 0 || g < 0) return (int)cudaErrorInvalidValue;
    const long long tiles_m = (m + BM - 1LL) / BM + g + 1;
    const long long tiles_n = (n + BN - 1LL) / BN;
    if (tiles_m > 0x7FFFFFFFLL || tiles_n > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles_m, (unsigned)tiles_n);
    cudaStream_t st = (cudaStream_t)stream;
    const int* gs = (const int*)group_sizes;
    if (bf16) {
        const __nv_bfloat16* a = (const __nv_bfloat16*)lhs;
        const __nv_bfloat16* b = (const __nv_bfloat16*)rhs;
        __nv_bfloat16* o = (__nv_bfloat16*)out;
        if (vec)
            ragged_dot_bf16_kernel<true><<<grid, 128, 0, st>>>(a, b, gs, o, m,
                                                               k, n, g);
        else
            ragged_dot_bf16_kernel<false><<<grid, 128, 0, st>>>(a, b, gs, o, m,
                                                                k, n, g);
    } else {
        const float* a = (const float*)lhs;
        const float* b = (const float*)rhs;
        float* o = (float*)out;
        if (vec)
            ragged_dot_f32_kernel<true><<<grid, 256, 0, st>>>(a, b, gs, o, m,
                                                              k, n, g);
        else
            ragged_dot_f32_kernel<false><<<grid, 256, 0, st>>>(a, b, gs, o, m,
                                                               k, n, g);
    }
    return (int)cudaGetLastError();
}
