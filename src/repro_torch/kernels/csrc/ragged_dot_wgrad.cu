// K6w — the weight gradient of K6 (ragged_dot), the grouped product
//   drhs[g] = lhs[rows of g]^T @ dout[rows of g]        [G, K, N]
// where group g holds the group_sizes[g] rows after those of groups < g,
// as K6 cuts them: a negative size counts as 0, every bound is clamped to
// M, and rows past sum(group_sizes) add nothing. lhs [M, K], dout [M, N],
// drhs [G, K, N]; float32 or bfloat16 in and out, float32 accumulation.
//
// Replaces the rhs half of the transpose rule XLA gives jax.lax.ragged_dot
// under jax.value_and_grad (src/repro/models/moe.py:81-83, differentiated
// by src/repro/train/step.py:66-69); the reference has no Pallas kernel
// for it. K6's data gradient needs no kernel of its own: it is K6 over dout
// and the transposed rhs (kernels/ragged_dot.py).
//
// What bounds it on the H100: the output. At qwen3-moe's expert
// up-projection (M 4096, K 2048, N 768, G 128, bf16) drhs is 403 MB
// against 23 MB of lhs and dout, about 0.13 ms at 3.35 TB/s, while the
// 2 M K N = 12.9 GFLOP of products take 13 us at the bf16 tensor-core
// rate. So every output byte is written once and never read.
//
// Design (a first, simple kernel: wgmma and TMA are later work):
//   * One CTA of 256 threads owns one 64 x 64 (K x N) tile of one group's
//     output: grid (ceil(N / 64), ceil(K / 64), G). It writes its whole
//     tile, zeros for an empty group, so drhs is allocated with
//     torch.empty and no tile is left unwritten.
//   * The group's start is read on the device: one warp sums
//     max(group_sizes[i], 0) over i < g, 32 entries a step (G is at most
//     160 at the MoE shapes), and clamps start and end to M. The wrapper
//     never reads the sizes on the host.
//   * The CTA loops over its group's rows 16 at a time, staging the 16 x 64
//     slices of lhs and dout in shared memory as float32 (rows past the
//     group's end are zeros); each thread keeps a 4 x 4 register tile and
//     adds one fmaf per row, in row order. Every output is one fmaf chain
//     over its group's rows from 0, with no atomics and no split of the
//     rows across CTAs: the result is deterministic, bit for bit from run
//     to run, which a resumed training run relies on.
//   * What it costs: on the H100 at qwen3-moe's up-projection the kernel
//     takes 0.78 ms in either type, against the 0.13 ms byte bound. With
//     about 32 rows a group, each of the 49,152 CTAs does two steps of
//     work behind its own scan of the sizes and its barriers. Neither the
//     bytes (bf16, half of them, takes as long as float32) nor the fmaf
//     rate (6.4 G fmaf in 0.78 ms is a quarter of the card's) sets the
//     time, which leaves those fixed costs per CTA. A CTA that keeps a
//     larger tile, or a persistent walk as K6 has, is the redesign.
//   * Offsets into lhs, dout and drhs are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;   // output rows (K) a CTA owns
constexpr int TN = 64;   // output columns (N) a CTA owns
constexpr int TR = 16;   // input rows staged per step
constexpr int PAD = 4;   // keeps rows 16-byte aligned, spreads the banks
constexpr int THREADS = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_dot_wgrad_kernel(
    const T* __restrict__ lhs,   // [M, K]
    const T* __restrict__ dout,  // [M, N]
    const int* __restrict__ gs,  // [G]
    T* __restrict__ drhs,        // [G, K, N]
    int M, int K, int N) {
    __shared__ long long bounds[2];
    __shared__ __align__(16) float As[TR][TK + PAD];  // lhs rows x k
    __shared__ __align__(16) float Bs[TR][TN + PAD];  // dout rows x n
    const int g = blockIdx.z;
    const int k0 = blockIdx.y * TK, n0 = blockIdx.x * TN;
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        long long before = 0;
        for (int base = 0; base < g; base += 32) {
            const int i = base + lane;
            long long v = i < g ? max(__ldg(gs + i), 0) : 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
            before += v;
        }
        if (lane == 0) {
            const long long size = max(__ldg(gs + g), 0);
            bounds[0] = min(before, (long long)M);
            bounds[1] = min(before + size, (long long)M);
        }
    }
    __syncthreads();
    const int r0 = (int)bounds[0], r1 = (int)bounds[1];
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int rr = r0; rr < r1; rr += TR) {
#pragma unroll
        for (int e = threadIdx.x; e < TR * TK; e += THREADS) {
            const int r = e / TK, c = e % TK;
            const int row = rr + r, kk = k0 + c;
            As[r][c] = row < r1 && kk < K
                           ? to_f32(lhs[(size_t)row * K + kk]) : 0.0f;
        }
#pragma unroll
        for (int e = threadIdx.x; e < TR * TN; e += THREADS) {
            const int r = e / TN, c = e % TN;
            const int row = rr + r, col = n0 + c;
            Bs[r][c] = row < r1 && col < N
                           ? to_f32(dout[(size_t)row * N + col]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < TR; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    T* out = drhs + (size_t)g * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = k0 + ty * 4 + i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (col < N) store(out + (size_t)k * N + col, acc[i][j]);
        }
    }
}

}  // namespace

// bf16: 1 for bfloat16, 0 for float32. Writes every element of drhs.
extern "C" int ragged_dot_wgrad_launch(
    const void* lhs, const void* dout, const void* group_sizes, void* drhs,
    int m, int k, int n, int g, int bf16, void* stream) {
    if (m < 0 || k < 0 || n < 0 || g < 0) return (int)cudaErrorInvalidValue;
    if (k == 0 || n == 0 || g == 0) return 0;
    const long long tiles_k = (k + TK - 1LL) / TK;
    const long long tiles_n = (n + TN - 1LL) / TN;
    if (tiles_n > 0x7FFFFFFFLL || tiles_k > 65535 || g > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles_n, (unsigned)tiles_k, (unsigned)g);
    cudaStream_t st = (cudaStream_t)stream;
    const int* gs = (const int*)group_sizes;
    if (bf16)
        ragged_dot_wgrad_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
            (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)dout, gs,
            (__nv_bfloat16*)drhs, m, k, n);
    else
        ragged_dot_wgrad_kernel<float><<<grid, THREADS, 0, st>>>(
            (const float*)lhs, (const float*)dout, gs, (float*)drhs, m, k, n);
    return (int)cudaGetLastError();
}
