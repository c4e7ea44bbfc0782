// K6w — the weight gradient of K6 (ragged_dot), the grouped product
//   drhs[g] = lhs[rows of g]^T @ dout[rows of g]        [G, K, N]
// where group g holds the group_sizes[g] rows after those of groups < g,
// as K6 cuts them: a negative size counts as 0, every bound is clamped to
// M, and rows past sum(group_sizes) add nothing. lhs [M, K], dout [M, N],
// drhs [G, K, N]; float32 or bfloat16 in and out, float32 accumulation; an
// empty group gets exact zeros.
//
// Replaces the rhs half of the transpose rule XLA gives jax.lax.ragged_dot
// under jax.value_and_grad (src/repro/models/moe.py:81-83, differentiated
// by src/repro/train/step.py:66-69); the reference has no Pallas kernel
// for it. K6's data gradient is K6 itself, reading rhs transposed in place
// (ragged_dot.cu's trans mode).
//
// What bounds it on the H100: the output. At qwen3-moe's expert
// up-projection as the trainer runs it (M 8192, K 2048, N 768, G 128, bf16)
// drhs is 403 MB against 46 MB of lhs and dout, 0.134 ms at 3.35 TB/s,
// while the 25.8 GFLOP of products take 26 us at the bf16 tensor-core
// rate. So the design keeps the output's stores streaming from every SM;
// in float32 the 12.9 G fmaf (0.385 ms at 67 TFLOP/s) bound it instead.
//
// Design (the TMA path: K and N multiples of the 16-byte vector, M, K, N
// and G positive, 16-byte aligned bases):
//   * Work items. An item is one group times one BKO x BNO = 128 x 128
//     tile of its drhs: G x ceil(K / 128) x ceil(N / 128) items, group
//     major, so the tiles of one group (which share its lhs and dout rows,
//     about 360 KB at the headline) run side by side across the card and
//     read those rows from DRAM once and from L2 after. A persistent grid
//     of min(items, SMs x CTAs per SM) CTAs walks items blockIdx.x,
//     blockIdx.x + gridDim.x, ...
//   * Finding a group's rows. The producer warp sums the sizes, 32 a step,
//     from a cursor kept between its items (groups only grow), so the host
//     never reads them and the scan runs ahead of the consumers.
//   * A ring of STAGES = 4 shared-memory stages of 32 KB, filled by TMA
//     from one producer lane, completion on an mbarrier per stage ("full"),
//     freed by the consumer warps' arrivals ("empty"). A stage holds RB
//     rows of the group (64 in bf16, 32 in float32) of lhs (the item's 128
//     k) and of dout (its 128 n); a group longer than a stage takes several,
//     wrapping the ring as often as it needs. The producer hands each item's
//     (group, rows, k0, n0) to the consumers in its first stage's slot of
//     `meta`; an empty group's item takes one stage with no load.
//   * The ragged reduction. A stage starts at a row of the group (TMA takes
//     any row), so its rows past the group's last row belong to the next
//     group, and rows past M arrive as zeros. bf16: the consumers zero the
//     rows past the group's last in all four boxes (lhs and dout both: a
//     non-finite value times 0 is NaN) and run all RB / 16 k-steps of the
//     stage (a fixed count: ptxas serializes wgmma in a loop whose count
//     varies, which ran slower at the headline). One group row
//     is one 128-byte line of a box, which the 128-byte swizzle permutes
//     only within itself, so whole lines are zeroed without decoding it;
//     then fence.proxy.async and a consumer barrier hand them to wgmma.
//     float32: the consumers loop over the valid rows only.
//   * bf16: two consumer warpgroups, each 64 of the tile's k, run
//     wgmma.mma_async m64n64k16 (two per 16-row step, one per 64-column
//     half) with the group's rows as the reduction: A is lhs^T, M-major in
//     shared memory (transpose-A 1), B is dout, N-major (transpose-B 1),
//     both in the 128-byte swizzle the TMA wrote. Each stage's chain of
//     wgmma starts from zero (scale-d 0) in registers of its own, and
//     float32 adds carry the stages' sums into the totals: one wgmma
//     accumulator over a group of about 3,100 rows drifts past the float32
//     bound at outputs near zero (phase 19a's long group).
//   * float32: eight consumer warps, each thread an 8 x 8 register tile
//     (k rows tk * 4 + i and 64 + tk * 4 + i, n columns likewise), 4
//     shared-memory vector loads per 64 fmaf, no TF32. A group's rows are
//     summed in blocks of SUM_BLOCK = 128 rows (four stages): an fmaf
//     chain from 0 over the block in row order, then the blocks' sums
//     added in order to a running total kept in the staging tile. One
//     chain over a long group drifts: over 3,500 rows of unit normals it
//     came 1.8 times the float32 bound (1e-4 (1 + |x|)) from the float64
//     sum, 128-row blocks 0.28 of it, the CPU's matmul 0.46
//     (tests/test_torch_ragged_grad.py::test_blocked_sums_on_a_long_group).
//     Blocks of 32 or 64 rows ran slower at the headline.
//     The simple kernel sums the same blocks in the same order: the same
//     bits.
//   * The epilogue: the accumulators are rounded once to the output type
//     into a shared-memory staging tile (bf16: two 64-column boxes in the
//     128-byte swizzle; float32: one plain 128 x 128 box, which already
//     holds the total; one tile each: a second ran no faster) and written
//     by one TMA store each (cp.async.bulk.tensor.3d.global.shared::cta) to
//     a 3-D map of drhs (N, K, G): the hardware clips the K and N tails, and
//     the group coordinate keeps deepseek-v2's 1.26 G-element drhs off
//     32-bit offsets. A tile is written again once its store has read it
//     (cp.async.bulk.wait_group.read), so one item's store overlaps the
//     next item's loads and products. An empty group's items store their
//     zero accumulators the same way.
//   * Deterministic: no atomics, no group's rows split across CTAs, every
//     output owned by one item. Two calls give the same bits, which a
//     resumed training run relies on.
//   * The launcher encodes the three tensor maps per call on the host
//     (cuTensorMapEncodeTiled, from libcuda, which needs a current
//     context) with the operands' device made current on the calling
//     thread until the launch, then the thread's own restored
//     (hopper::DeviceOf): autograd's worker, which runs the backward, may
//     have no context.
//   * The simple kernel (shapes TMA cannot describe: K or N off the 16-byte
//     vector, a base off 16 bytes, M 0): one CTA of 256 threads per 64 x 64
//     output tile of one group, grid (ceil(N / 64), ceil(K / 64), G), 16
//     rows staged at a time as float32 through shared memory, a 4 x 4
//     register tile per thread, one fmaf per row, 128-row blocks summed as
//     above; its scan of the sizes is its own. It also holds the TMA path
//     to the same float32 bits on the card. Offsets into lhs, dout and drhs
//     are 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------- the simple kernel

constexpr int TK = 64;   // output rows (K) a CTA owns
constexpr int TN = 64;   // output columns (N) a CTA owns
constexpr int TR = 16;   // input rows staged per step
constexpr int PAD = 4;   // keeps rows 16-byte aligned, spreads the banks
constexpr int THREADS = 256;
// rows one fmaf chain sums from 0 before the chain joins the total: both
// kernels sum a group's rows this way (a whole number of the simple
// kernel's steps and of the TMA path's float32 stages)
constexpr int SUM_BLOCK = 128;
static_assert(SUM_BLOCK % TR == 0, "a block is whole steps");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ragged_dot_wgrad_simple(
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
    float acc[4][4], tot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.0f;

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
        if ((rr - r0 + TR) % SUM_BLOCK == 0 || rr + TR >= r1) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    tot[i][j] += acc[i][j];
                    acc[i][j] = 0.0f;
                }
        }
    }
    T* out = drhs + (size_t)g * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = k0 + ty * 4 + i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (col < N) store(out + (size_t)k * N + col, tot[i][j]);
        }
    }
}

// ---------------------------------------------------------- the TMA path

constexpr int BKO = 128, BNO = 128;  // an item's output tile, K x N
constexpr int STAGES = 4;
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int TMA_THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int BAR_CONSUMERS = 1;             // named barrier of the consumers

// RB: group rows a stage holds. BOX: a box's width along k or n (the
// 128-byte swizzle's limit in bf16), also the store box's width along n.
struct WgBf16 {
    using T = __nv_bfloat16;
    static constexpr int RB = 64, BOX = 64;
    static constexpr bool SWIZZLE = true;  // the 128-byte one wgmma reads
};
struct WgF32 {
    using T = float;
    static constexpr int RB = 32, BOX = 128;
    static constexpr bool SWIZZLE = false;  // read and written along rows
};
static_assert(SUM_BLOCK % WgF32::RB == 0, "a block is whole stages");

// A stage: lhs boxes (k 0 .. BKO) then dout boxes (n 0 .. BNO), RB rows
// each; then one staging tile of BKO x BNO outputs.
template <class C>
struct WRing {
    using T = typename C::T;
    static constexpr int BOXES = BKO / C::BOX;  // per operand (BNO == BKO)
    static constexpr int BOX_BYTES = C::RB * C::BOX * (int)sizeof(T);
    static constexpr int A_BYTES = BOXES * BOX_BYTES;
    static constexpr int STAGE_BYTES = 2 * A_BYTES;
    static constexpr int OUT_BOX_BYTES = BKO * C::BOX * (int)sizeof(T);
    static constexpr int OUT_BYTES = BKO * BNO * (int)sizeof(T);
    static constexpr int SMEM =
        STAGES * STAGE_BYTES + OUT_BYTES + 1024;  // + alignment
};

struct WItem {
    int group;  // -1: no more items for this CTA
    int row0;   // the group's rows [row0, row1)
    int row1;
    int k0;
    int n0;
};

// Groups before `base` are summed into row_base; groups are looked up in
// increasing order from one cursor.
struct GroupCursor {
    int base = 0;
    long long row_base = 0;
};

// A whole warp: the rows [row0, row1) of group g (every lane gets them).
// `g` is never below the previous call's on `c`.
__device__ void group_rows(const int* __restrict__ gs, int G, int M, int g,
                           GroupCursor& c, int& row0, int& row1) {
    const int lane = threadIdx.x & 31;
    for (; g >= c.base + 32; c.base += 32) {
        const int i = c.base + lane;
        long long v = i < G ? max(__ldg(gs + i), 0) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        c.row_base += v;
    }
    const int i = c.base + lane;
    const long long size = i < G ? max(__ldg(gs + i), 0) : 0;
    const long long incl = warp_incl_scan(size, lane);
    const int src = g - c.base;
    const long long start = c.row_base + __shfl_sync(kFull, incl - size, src);
    const long long end = start + __shfl_sync(kFull, size, src);
    row0 = (int)min(start, (long long)M);
    row1 = (int)min(end, (long long)M);
}

// The producer warp (the last warp of the CTA): finds each item's group
// rows and fills the ring; lane 0 starts the copies.
template <class C>
__device__ void wgrad_produce(const CUtensorMap* lhs_map,
                              const CUtensorMap* dout_map,
                              const int* __restrict__ gs, int M, int K, int N,
                              int G, long long items, uint8_t* smem,
                              uint64_t* full, uint64_t* empty, WItem* meta) {
    using R = WRing<C>;
    const int lane = threadIdx.x & 31;
    const int tiles_n = (N + BNO - 1) / BNO;
    const long long per_group = (long long)((K + BKO - 1) / BKO) * tiles_n;
    GroupCursor cur;
    RingPos<STAGES> r;
    for (long long item = blockIdx.x;; item += gridDim.x) {
        const bool stop = item >= items;
        WItem it{-1, 0, 0, 0, 0};
        if (!stop) {
            const long long t = item % per_group;
            it.group = (int)(item / per_group);
            it.k0 = (int)(t / tiles_n) * BKO;
            it.n0 = (int)(t % tiles_n) * BNO;
            group_rows(gs, G, M, it.group, cur, it.row0, it.row1);
        }
        if (lane == 0) {
            const int boxes = (it.row1 - it.row0 + C::RB - 1) / C::RB;
            const int steps = boxes > 0 ? boxes : 1;
            for (int b = 0; b < steps; ++b) {
                mbar_wait(&empty[r.s], r.phase ^ 1);
                if (b == 0) meta[r.s] = it;
                if (boxes == 0) {
                    mbar_arrive(&full[r.s]);
                } else {
                    uint8_t* st = smem + r.s * R::STAGE_BYTES;
                    const int row = it.row0 + b * C::RB;
                    mbar_expect_tx(&full[r.s], R::STAGE_BYTES);
#pragma unroll
                    for (int i = 0; i < R::BOXES; ++i) {
                        tma_load_2d(st + i * R::BOX_BYTES, lhs_map,
                                    &full[r.s], it.k0 + i * C::BOX, row);
                        tma_load_2d(st + R::A_BYTES + i * R::BOX_BYTES,
                                    dout_map, &full[r.s], it.n0 + i * C::BOX,
                                    row);
                    }
                }
                r.next();
            }
        }
        __syncwarp();
        if (stop) return;
    }
}

// bf16: the accumulators of one item over all of its stages. Warpgroup wg
// owns the tile's k rows [64 wg, 64 wg + 64); acc0 and acc1 its n columns
// [0, 64) and [64, 128). Each stage's chain starts from zero in part0 and
// part1 and is then added to acc0 and acc1 by float32 adds: the tensor
// cores' own accumulation drifts over long chains.
__device__ __forceinline__ void wgrad_bf16_item(const WItem& it, uint8_t* smem,
                                                uint64_t* full,
                                                uint64_t* empty,
                                                RingPos<STAGES>& r,
                                                float (&acc0)[32],
                                                float (&acc1)[32]) {
    using C = WgBf16;
    using R = WRing<C>;
    const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
    const int rows = it.row1 - it.row0;
    const int boxes = (rows + C::RB - 1) / C::RB;
    if (boxes == 0) {  // an empty group: its stage carried no load
        release(&empty[r.s], lane);
        r.next();
        return;
    }
    for (int b = 0; b < boxes; ++b) {
        if (b > 0) mbar_wait(&full[r.s], r.phase);
        uint8_t* st = smem + r.s * R::STAGE_BYTES;
        const int valid = min(C::RB, rows - b * C::RB);
        // every 16-row step of the stage: a fixed count keeps the wgmma
        // chain out of divergent branches, which ptxas serializes
        const int steps = C::RB / 16;
        if (valid < steps * 16) {
            // rows [valid, 16 steps) of the four boxes: whole 128-byte
            // lines, 16 bytes a store
            const int lines = (steps * 16 - valid) * 2 * R::BOXES;
            for (int e = threadIdx.x; e < lines * 8; e += CONSUMERS) {
                const int line = e >> 3;
                const int box = line % (2 * R::BOXES);
                const int row = valid + line / (2 * R::BOXES);
                *reinterpret_cast<uint4*>(st + box * R::BOX_BYTES +
                                          row * 128 + (e & 7) * 16) =
                    make_uint4(0, 0, 0, 0);
            }
            fence_proxy_async();
            named_sync(BAR_CONSUMERS, CONSUMERS);
        }
        const uint32_t a = smem_u32(st + wg * R::BOX_BYTES);
        const uint32_t d = smem_u32(st + R::A_BYTES);
        float part0[32], part1[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < steps; ++kk) {
            // lhs and dout alike: 128-byte rows of 64 k (n) per group row,
            // 8-row groups 1024 bytes apart; a 16-row step is 2048 bytes.
            // The stage's first step starts part0 and part1 from zero
            // (scale-d 0), so no other instruction writes them first.
            const int keep = kk > 0;
            const uint64_t da = sw128_desc(a + kk * 2048, R::BOX_BYTES, 1024);
            wgmma_m64n64k16<1, 1>(
                part0, da, sw128_desc(d + kk * 2048, R::BOX_BYTES, 1024),
                keep);
            wgmma_m64n64k16<1, 1>(
                part1, da,
                sw128_desc(d + R::BOX_BYTES + kk * 2048, R::BOX_BYTES, 1024),
                keep);
        }
        wgmma_commit_and_wait();
        release(&empty[r.s], lane);
        r.next();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            acc0[i] += part0[i];
            acc1[i] += part1[i];
        }
    }
}

// bf16: one 64-column half of the accumulators into its staging box (128 k
// rows of 128 bytes, the 128-byte swizzle: 16-byte chunk j of row k at
// j ^ (k % 8)), rounded once (nearest even). The fragment holds k rows ka
// and ka + 8 at columns 8 j + 2 (lane % 4) (+ 1).
__device__ __forceinline__ void stage_bf16_half(uint8_t* box,
                                                const float (&d)[32], int ka,
                                                int lane) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int k = ka + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                box + k * 128 + ((j ^ (k & 7)) << 4) + (lane & 3) * 4) =
                __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
    }
}

// float32: one item over all of its stages, summed in blocks of SUM_BLOCK
// rows (BLOCK_STAGES stages): an fmaf chain from 0 over the block's rows in
// order, then added block by block to the total kept in the staging tile
// `out` ([BKO][BNO]), which the first block writes once the tile's last
// store has read it (an empty group writes zeros). Thread (tk, tn) owns k
// rows tk * 4 + i and 64 + tk * 4 + i (acc[i], acc[4 + i]) and n columns
// tn * 4 + j and 64 + tn * 4 + j (acc[.][j], acc[.][4 + j]).
__device__ __forceinline__ void wgrad_f32_item(const WItem& it, uint8_t* smem,
                                               uint64_t* full,
                                               uint64_t* empty,
                                               RingPos<STAGES>& r,
                                               float* __restrict__ out) {
    using C = WgF32;
    using R = WRing<C>;
    constexpr int BLOCK_STAGES = SUM_BLOCK / C::RB;
    const int lane = threadIdx.x & 31;
    const int tk = threadIdx.x >> 4, tn = threadIdx.x & 15;
    const int rows = it.row1 - it.row0;
    const int boxes = max((rows + C::RB - 1) / C::RB, 1);
    float acc[8][8];
    for (int b = 0; b < boxes; ++b) {
        if (b % BLOCK_STAGES == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        }
        if (b > 0) mbar_wait(&full[r.s], r.phase);
        const float* As = reinterpret_cast<const float*>(
            smem + r.s * R::STAGE_BYTES);      // [RB][BKO]
        const float* Bs = As + C::RB * BKO;    // [RB][BNO]
        // 0 for an empty group, whose stage carried no load
        const int valid = max(min(C::RB, rows - b * C::RB), 0);
#pragma unroll 4
        for (int q = 0; q < valid; ++q) {
            const float* ar = As + q * BKO + tk * 4;
            const float* br = Bs + q * BNO + tn * 4;
            const float4 a0 = *reinterpret_cast<const float4*>(ar);
            const float4 a1 = *reinterpret_cast<const float4*>(ar + 64);
            const float4 b0 = *reinterpret_cast<const float4*>(br);
            const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        release(&empty[r.s], lane);
        r.next();
        if (b == 0) {
            if (threadIdx.x == 0) store_wait_read();
            named_sync(BAR_CONSUMERS, CONSUMERS);
        }
        if ((b + 1) % BLOCK_STAGES != 0 && b + 1 < boxes) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int k = (i >> 2) * 64 + tk * 4 + (i & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float4* p = reinterpret_cast<float4*>(out + k * BNO + h * 64 +
                                                      tn * 4);
                float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                       acc[i][4 * h + 2], acc[i][4 * h + 3]);
                if (b >= BLOCK_STAGES) {
                    const float4 t = *p;
                    v = make_float4(t.x + v.x, t.y + v.y, t.z + v.z,
                                    t.w + v.w);
                }
                *p = v;
            }
        }
    }
}

template <class C>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    ragged_dot_wgrad_tma(const __grid_constant__ CUtensorMap lhs_map,
                         const __grid_constant__ CUtensorMap dout_map,
                         const __grid_constant__ CUtensorMap out_map,
                         const int* __restrict__ gs, int M, int K, int N,
                         int G, long long items) {
    using R = WRing<C>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    __shared__ WItem meta[STAGES];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMER_WARPS);
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (warp == CONSUMER_WARPS) {
        wgrad_produce<C>(&lhs_map, &dout_map, gs, M, K, N, G, items, smem,
                         full, empty, meta);
        return;
    }
    uint8_t* out = smem + STAGES * R::STAGE_BYTES;  // the staging tile
    RingPos<STAGES> r;
    for (;;) {
        mbar_wait(&full[r.s], r.phase);
        const WItem it = meta[r.s];
        if (it.group < 0) break;
        if constexpr (sizeof(typename C::T) == 2) {
            float acc0[32], acc1[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;
            wgrad_bf16_item(it, smem, full, empty, r, acc0, acc1);
            // the tile's last store has read it
            if (threadIdx.x == 0) store_wait_read();
            named_sync(BAR_CONSUMERS, CONSUMERS);
            const int ka = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
            stage_bf16_half(out, acc0, ka, lane);
            stage_bf16_half(out + R::OUT_BOX_BYTES, acc1, ka, lane);
        } else {
            wgrad_f32_item(it, smem, full, empty, r,
                           reinterpret_cast<float*>(out));
        }
        fence_proxy_async();
        named_sync(BAR_CONSUMERS, CONSUMERS);
        if (threadIdx.x == 0) {
#pragma unroll
            for (int h = 0; h < BNO / C::BOX; ++h)
                tma_store_3d(&out_map, out + h * R::OUT_BOX_BYTES,
                             it.n0 + h * C::BOX, it.k0, it.group);
            store_commit();
        }
    }
    if (threadIdx.x == 0) store_wait_all();
}

// lhs [M, K] and dout [M, N] as 2-D maps (K or N inner) in BOX x RB boxes;
// drhs [G, K, N] as a 3-D map (N inner, then K, then G) in BOX x BKO x 1
// boxes. bf16 takes the 128-byte swizzle (wgmma reads it; the staging
// tile's writes spread over the banks), float32 none.
template <class C>
int encode_wgrad_maps(const void* lhs, const void* dout, void* drhs, int m,
                      int k, int n, int g, CUtensorMap* lhs_map,
                      CUtensorMap* dout_map, CUtensorMap* out_map) {
    const bool bf16 = sizeof(typename C::T) == 2;
    const CUtensorMapDataType dt = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapSwizzle sw =
        C::SWIZZLE ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
    const cuuint64_t el = sizeof(typename C::T);
    const cuuint32_t ones[3] = {1, 1, 1};
    const cuuint32_t in_box[2] = {(cuuint32_t)C::BOX, (cuuint32_t)C::RB};
    const cuuint64_t l_dim[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t l_str[1] = {(cuuint64_t)k * el};
    const cuuint64_t d_dim[2] = {(cuuint64_t)n, (cuuint64_t)m};
    const cuuint64_t d_str[1] = {(cuuint64_t)n * el};
    const cuuint64_t o_dim[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)g};
    const cuuint64_t o_str[2] = {(cuuint64_t)n * el,
                                 (cuuint64_t)n * (cuuint64_t)k * el};
    const cuuint32_t o_box[3] = {(cuuint32_t)C::BOX, (cuuint32_t)BKO, 1};
    CUresult r = cuTensorMapEncodeTiled(
        lhs_map, dt, 2, const_cast<void*>(lhs), l_dim, l_str, in_box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r == CUDA_SUCCESS)
        r = cuTensorMapEncodeTiled(
            dout_map, dt, 2, const_cast<void*>(dout), d_dim, d_str, in_box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r == CUDA_SUCCESS)
        r = cuTensorMapEncodeTiled(
            out_map, dt, 3, drhs, o_dim, o_str, o_box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class C>
int launch_wgrad_tma(int* cache, const void* lhs, const void* dout,
                     const int* gs, void* drhs, int m, int k, int n, int g,
                     cudaStream_t st) {
    CUtensorMap lhs_map, dout_map, out_map;
    int err = encode_wgrad_maps<C>(lhs, dout, drhs, m, k, n, g, &lhs_map,
                                   &dout_map, &out_map);
    if (err) return err;
    const int ctas = persistent_ctas(ragged_dot_wgrad_tma<C>, TMA_THREADS,
                                     WRing<C>::SMEM, cache);
    if (ctas < 0) return -ctas;
    const long long items = (long long)g * ((k + BKO - 1LL) / BKO) *
                            ((n + BNO - 1LL) / BNO);
    const int grid = (int)(items < ctas ? items : ctas);
    ragged_dot_wgrad_tma<C><<<grid, TMA_THREADS, WRing<C>::SMEM, st>>>(
        lhs_map, dout_map, out_map, gs, m, k, n, g, items);
    return (int)cudaGetLastError();
}

int bf16_ctas[64], f32_ctas[64];

}  // namespace

// bf16: 1 for bfloat16, 0 for float32. tma: the TMA path (K and N are
// multiples of the 16-byte vector, 8 bf16 or 4 float32, M is positive and
// lhs, dout and drhs are 16-byte aligned); else the simple kernel. Writes
// every element of drhs.
extern "C" int ragged_dot_wgrad_launch(
    const void* lhs, const void* dout, const void* group_sizes, void* drhs,
    int m, int k, int n, int g, int bf16, int tma, void* stream) {
    if (m < 0 || k < 0 || n < 0 || g < 0) return (int)cudaErrorInvalidValue;
    if (k == 0 || n == 0 || g == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int* gs = (const int*)group_sizes;
    if (tma) {
        if (m == 0) return (int)cudaErrorInvalidValue;
        const DeviceOf dev(lhs);  // until the launch has returned
        if (dev.err != cudaSuccess) return (int)dev.err;
        return bf16 ? launch_wgrad_tma<WgBf16>(bf16_ctas, lhs, dout, gs, drhs,
                                               m, k, n, g, st)
                    : launch_wgrad_tma<WgF32>(f32_ctas, lhs, dout, gs, drhs,
                                              m, k, n, g, st);
    }
    const long long tiles_k = (k + TK - 1LL) / TK;
    const long long tiles_n = (n + TN - 1LL) / TN;
    if (tiles_n > 0x7FFFFFFFLL || tiles_k > 65535 || g > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles_n, (unsigned)tiles_k, (unsigned)g);
    if (bf16)
        ragged_dot_wgrad_simple<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
            (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)dout, gs,
            (__nv_bfloat16*)drhs, m, k, n);
    else
        ragged_dot_wgrad_simple<float><<<grid, THREADS, 0, st>>>(
            (const float*)lhs, (const float*)dout, gs, (float*)drhs, m, k, n);
    return (int)cudaGetLastError();
}
