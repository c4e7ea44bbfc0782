// K6 — grouped matrix product over expert-sorted rows (ragged_dot):
//   out[r, :] = lhs[r, :] @ rhs[g(r)]   for the rows r of group g,
// where group g holds the group_sizes[g] rows after those of groups < g;
// rows past sum(group_sizes) are zero, and a group that runs past row M is
// cut there (a negative size counts as 0). lhs [M, K], rhs [G, K, N],
// out [M, N], float32 or bfloat16 in and out, float32 accumulation.
//
// Replaces XLA's jax.lax.ragged_dot in moe_ragged
// (src/repro/models/moe.py:81-83); the reference has no Pallas kernel for
// it. The group sizes are read on the device: the host launches for an
// upper bound of row tiles and never syncs on them.
//
// What bounds it on the H100: at the MoE shapes (M = tokens x top-k of a
// few thousand, K and N of 768 to 5120, 128 to 160 groups) each group's
// rhs holds most of the bytes: about 0.4 GB for qwen3-moe's expert
// up-projection, 127 us at 3.35 TB/s, against 13 us of bf16 tensor-core
// work. So bytes: every row tile reads its group's rhs once per N tile,
// and with groups of at most 64 rows that is each rhs byte once. The
// kernel's job is to keep enough of those bytes in flight on every SM.
//
// Design (the TMA path: K and N multiples of 16 bytes' worth of elements,
// 16-byte aligned bases):
//   * Work items. An item is one row tile (BM = 64 rows of one group; a
//     tile never straddles two groups) times one BN = 128 column tile. Row
//     tiles come in group order, then the tiles of the zero rows past the
//     sum; there are at most ceil(M / 64) + G + 1 of them, which the host
//     knows without reading the sizes. Items are numbered row tile major,
//     so the N tiles of one row tile (which share its lhs rows) and the row
//     tiles of one group (which share its rhs) run side by side and meet in
//     L2. A persistent grid of min(items, SMs x CTAs per SM) CTAs walks
//     items blockIdx.x, blockIdx.x + gridDim.x, ... and stops at the first
//     past the real count.
//   * Finding a row tile. The producer warp scans the group sizes, 32
//     groups a step (find_tile), from a cursor kept between its items:
//     items only grow, so each search resumes at the chunk of the last one.
//     The scan runs ahead of the consumers by the depth of the ring, so it
//     costs them nothing; no prologue kernel and no scratch are needed.
//   * A ring of STAGES = 4 shared-memory stages of 24 KB, filled by TMA
//     (cp.async.bulk.tensor) from one producer lane, completion on an
//     mbarrier per stage ("full"), freed by the consumer warps' arrivals
//     ("empty"). The producer hands each item's (group, rows, n0) to the
//     consumers in the stage's slot of `meta`, written before its arrival
//     on "full". rhs is a 3-D tensor map (N, K, G): a K tail is zero-filled
//     inside its own group, and the group coordinate keeps deepseek-v2's
//     1.26 G-element rhs off 64-bit offsets. The launcher encodes both
//     tensor maps per call on the host (cuTensorMapEncodeTiled, from
//     libcuda, which the build links) and passes them as
//     __grid_constant__ parameters; it never syncs. lhs rows past M are
//     zero-filled; rows past the tile's last row belong to the next group
//     and are loaded, multiplied and never stored.
//   * bfloat16: one consumer warpgroup runs wgmma.mma_async m64n64k16 (two
//     per 16-deep step, one per 64-column half of the tile) from shared
//     memory, float32 accumulators in registers; lhs is K-major and rhs
//     N-major (the transpose bit for B), both with the 128-byte swizzle the
//     TMA wrote (64-wide boxes, the swizzle's limit). The accumulators are
//     rounded once to bf16 (nearest even) and stored from registers, only
//     rows [row0, row1) and columns below N.
//   * float32: eight consumer warps, each eight rows of the tile, each lane
//     a 4 x 8 register micro-tile (12 shared-memory vector loads per 128
//     FMAs); a warp whose rows all lie past the tile's last row skips the
//     arithmetic. Each output is one chain of fmaf over k = 0 .. K - 1 in
//     order, from 0, with no TF32: deterministic, and the same bits as the
//     simple kernel below. The consumers, not the bytes, bound it (on the
//     H100 at qwen3-moe's up-projection, 0.55 ms against 0.25 ms of
//     bytes): with about 32 real rows a tile, each shared-memory load feeds
//     few FMAs. Layouts that spread those rows over more warps but took
//     more loads per FMA (warps splitting columns, or half-width warps for
//     tiles of at most 32 rows) ran no faster there.
//   * The data gradient's mode (trans): rhs stored [G, N, K] is read
//     transposed, out = lhs @ rhs[g]^T, so the backward needs no transposed
//     copy of rhs. The same 3-D map over rhs (its dims as stored) and the
//     same box shape; only the coordinates swap: the inner one is the
//     reduction, the next the output column. bf16: the rhs stage is then
//     K-major, described as lhs is (32 bytes a 16-deep step, SBO 1024),
//     with wgmma's transpose-B bit 0. float32: the rhs stage is 128 rows of
//     32 reduction values, in the 128-byte swizzle; a lane takes columns
//     tx + 16 j and reads 16-byte chunks along the reduction, so the eight
//     lanes of a quarter warp read eight different bank groups. Each output
//     stays one fmaf chain over the reduction in order: the bits of K6 over
//     a transposed copy.
//   * While it encodes the maps and launches, the launcher makes the
//     operands' device current on the calling thread and then restores the
//     thread's device (hopper::DeviceOf): the encode (libcuda) needs a
//     current context, which a thread whose only CUDA work is ours
//     (autograd's worker) may not have.
//   * The simple kernels (shapes TMA cannot describe): one CTA per 64 x 64
//     output tile of an upper bound of row tiles, scalar loads into one
//     shared-memory stage, WMMA bf16 or the same fmaf chain in float32.
//   * Offsets into out are 64-bit (row * N).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;

struct Tile {
    int group;  // -1: zero rows past the sum
    int row0;   // first row; row0 >= row1: past the real tiles
    int row1;   // one past the last row
};

// Groups before `base` are summed into row_base (rows) and tile_base (row
// tiles); row tiles are looked up in increasing order from one cursor.
struct Cursor {
    int base = 0;
    long long row_base = 0;
    long long tile_base = 0;
};

// A whole warp: which group and rows row tile `tile` covers (every lane
// gets the answer). `tile` is never below the previous call's on `c`.
__device__ Tile find_tile(const int* __restrict__ gs, int G, int M,
                          long long tile, Cursor& c) {
    const int lane = threadIdx.x & 31;
    for (; c.base < G; c.base += 32) {
        const int g = c.base + lane;
        const long long size = g < G ? max(__ldg(gs + g), 0) : 0;
        const long long incl = warp_incl_scan(size, lane);
        const long long s_c = min(c.row_base + incl - size, (long long)M);
        const long long e_c = min(c.row_base + incl, (long long)M);
        const long long tiles = (e_c - s_c + BM - 1) / BM;
        const long long t_incl = warp_incl_scan(tiles, lane);
        const long long t_start = c.tile_base + t_incl - tiles;
        const unsigned mine =
            __ballot_sync(kFull, tile >= t_start && tile < t_start + tiles);
        if (mine) {
            const int src = __ffs(mine) - 1;
            const long long r0 = s_c + (tile - t_start) * BM;
            Tile t;
            t.group = c.base + src;
            t.row0 = (int)__shfl_sync(kFull, r0, src);
            t.row1 = (int)__shfl_sync(kFull, min(r0 + BM, e_c), src);
            return t;
        }
        c.row_base += __shfl_sync(kFull, incl, 31);
        c.tile_base += __shfl_sync(kFull, t_incl, 31);
    }
    // the zero rows past the sum
    const long long r0 =
        min(c.row_base, (long long)M) + (tile - c.tile_base) * BM;
    Tile t;
    t.group = -1;
    t.row0 = (int)min(r0, (long long)M);
    t.row1 = (int)min(r0 + BM, (long long)M);
    return t;
}

// -------------------------------------------------------- the TMA path

// One stage: a BM x BK lhs box, then BK x BN of rhs as B_BOXES boxes of
// B_BOX_N columns (TB, rhs read transposed: BN x BK, B_BOX_N rows of BK
// each). Both dtypes take 24 KB a stage.
struct Bf16Cfg {
    using T = __nv_bfloat16;
    static constexpr int BN = 128, BK = 64, B_BOXES = 2, B_BOX_N = 64;
    static constexpr int CONSUMER_WARPS = 4;
    static constexpr bool SWIZZLE = true;  // the 128-byte one wgmma reads
};
struct F32Cfg {
    using T = float;
    static constexpr int BN = 128, BK = 32, B_BOXES = 1, B_BOX_N = 128;
    static constexpr int CONSUMER_WARPS = 8;
    static constexpr bool SWIZZLE = false;  // read along plain rows; TB's
                                            // rhs box takes the 128-byte one
};

constexpr int STAGES = 4;

template <class C>
struct Ring {
    static constexpr int A_BYTES = BM * C::BK * (int)sizeof(typename C::T);
    static constexpr int B_BOX_BYTES =
        C::BK * C::B_BOX_N * (int)sizeof(typename C::T);
    static constexpr int STAGE_BYTES = A_BYTES + C::B_BOXES * B_BOX_BYTES;
    static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
    static constexpr int THREADS = (C::CONSUMER_WARPS + 1) * 32;
};

struct Item {
    int group;  // -1: zero rows
    int row0;
    int row1;   // row0 >= row1: no more items for this CTA
    int n0;
};

using RingState = RingPos<STAGES>;

// The producer warp (the last warp of the CTA): finds each item's row tile
// and fills the ring; lane 0 starts the copies. TB: rhs is stored [G, N, K]
// (the map's inner coordinate is the reduction, the next the column).
template <class C, bool TB>
__device__ void produce(const CUtensorMap* lhs_map, const CUtensorMap* rhs_map,
                        const int* __restrict__ gs, int M, int K, int N,
                        int G, long long items, uint8_t* smem, uint64_t* full,
                        uint64_t* empty, Item* meta) {
    using R = Ring<C>;
    const int lane = threadIdx.x & 31;
    const int n_tiles = (N + C::BN - 1) / C::BN;
    const int nkb = (K + C::BK - 1) / C::BK;
    Cursor cur;
    RingState r;
    for (long long item = blockIdx.x;; item += gridDim.x) {
        Tile t{-1, 0, 0};
        if (item < items) t = find_tile(gs, G, M, item / n_tiles, cur);
        const bool stop = t.row0 >= t.row1;
        const bool load = !stop && t.group >= 0;
        const int n0 = (int)(item % n_tiles) * C::BN;
        if (lane == 0) {
            const int steps = load ? nkb : 1;
            for (int kb = 0; kb < steps; ++kb) {
                mbar_wait(&empty[r.s], r.phase ^ 1);
                if (kb == 0) meta[r.s] = Item{t.group, t.row0, t.row1, n0};
                if (!load) {
                    mbar_arrive(&full[r.s]);
                } else {
                    uint8_t* st = smem + r.s * R::STAGE_BYTES;
                    mbar_expect_tx(&full[r.s], R::STAGE_BYTES);
                    tma_load_2d(st, lhs_map, &full[r.s], kb * C::BK, t.row0);
#pragma unroll
                    for (int b = 0; b < C::B_BOXES; ++b)
                        tma_load_3d(st + R::A_BYTES + b * R::B_BOX_BYTES,
                                    rhs_map, &full[r.s],
                                    TB ? kb * C::BK : n0 + b * C::B_BOX_N,
                                    TB ? n0 + b * C::B_BOX_N : kb * C::BK,
                                    t.group);
                }
                r.next();
            }
        }
        __syncwarp();
        if (stop) return;
    }
}

// Zero rows [row0, row1) x columns [n0, n0 + BN) below N, 16 bytes a store
// (N is a multiple of the 16-byte vector on the TMA path).
template <class C>
__device__ void store_zero_rows(typename C::T* __restrict__ out,
                                const Item& it, int N) {
    constexpr int PER = 16 / (int)sizeof(typename C::T);
    constexpr int CHUNKS = BM * C::BN / PER;
    for (int e = threadIdx.x; e < CHUNKS; e += C::CONSUMER_WARPS * 32) {
        const int row = it.row0 + e / (C::BN / PER);
        const int col = it.n0 + (e % (C::BN / PER)) * PER;
        if (row < it.row1 && col < N)
            *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
                make_uint4(0, 0, 0, 0);
    }
}

// One 64-column half of the bf16 accumulators, rounded once to bf16
// (nearest even). The fragment holds rows ra and ra + 8 (ra = warp * 16 +
// lane / 4 past the tile's first row) at columns 8 j + 2 (lane % 4) (+ 1).
__device__ __forceinline__ void store_bf16_half(
    __nv_bfloat16* __restrict__ out, const float (&d)[32], int ra, int row1,
    int cb, int N) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = cb + j * 8;
        if (col >= N) continue;
        if (ra < row1)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)ra * N + col) =
                __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        if (ra + 8 < row1)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(ra + 8) * N +
                                               col) =
                __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
}

template <bool TB>
__global__ void __launch_bounds__(Ring<Bf16Cfg>::THREADS)
    ragged_dot_bf16_tma(const __grid_constant__ CUtensorMap lhs_map,
                        const __grid_constant__ CUtensorMap rhs_map,
                        const int* __restrict__ gs,
                        __nv_bfloat16* __restrict__ out, int M, int K, int N,
                        int G, long long items) {
    using C = Bf16Cfg;
    using R = Ring<C>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    __shared__ Item meta[STAGES];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], C::CONSUMER_WARPS);
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (warp == C::CONSUMER_WARPS) {
        produce<C, TB>(&lhs_map, &rhs_map, gs, M, K, N, G, items, smem, full,
                       empty, meta);
        return;
    }
    const int nkb = (K + C::BK - 1) / C::BK;
    RingState r;
    for (;;) {
        mbar_wait(&full[r.s], r.phase);
        const Item it = meta[r.s];
        if (it.row0 >= it.row1) return;
        if (it.group < 0) {
            store_zero_rows<C>(out, it, N);
            release(&empty[r.s], lane);
            r.next();
            continue;
        }
        float acc0[32], acc1[32];  // columns n0 + [0, 64) and [64, 128)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;
        for (int kb = 0; kb < nkb; ++kb) {
            if (kb > 0) mbar_wait(&full[r.s], r.phase);
            const uint32_t a = smem_u32(smem + r.s * R::STAGE_BYTES);
            const uint32_t b = a + R::A_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::BK / 16; ++kk) {
                // lhs: 128-byte rows of 64 k, 8-row groups 1024 bytes apart;
                // a 16-deep step is 32 bytes along the row. rhs: 128-byte
                // rows of 64 n per k, 8-k groups 1024 bytes apart; a step is
                // 16 rows (2048 bytes); the two 64-column boxes are
                // B_BOX_BYTES apart. TB: rhs is K-major as lhs is (rows of
                // 64 k per output column), a step 32 bytes along the row.
                const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
                if (TB) {
                    wgmma_m64n64k16<0, 0>(
                        acc0, da, sw128_desc(b + kk * 32, 16, 1024));
                    wgmma_m64n64k16<0, 0>(
                        acc1, da,
                        sw128_desc(b + R::B_BOX_BYTES + kk * 32, 16, 1024));
                } else {
                    wgmma_m64n64k16<0, 1>(
                        acc0, da,
                        sw128_desc(b + kk * 2048, R::B_BOX_BYTES, 1024));
                    wgmma_m64n64k16<0, 1>(
                        acc1, da,
                        sw128_desc(b + R::B_BOX_BYTES + kk * 2048,
                                   R::B_BOX_BYTES, 1024));
                }
            }
            wgmma_commit_and_wait();
            release(&empty[r.s], lane);
            r.next();
        }
        const int ra = it.row0 + warp * 16 + (lane >> 2);
        const int cb = it.n0 + (lane & 3) * 2;
        store_bf16_half(out, acc0, ra, it.row1, cb, N);
        store_bf16_half(out, acc1, ra, it.row1, cb + 64, N);
    }
}

template <bool TB>
__global__ void __launch_bounds__(Ring<F32Cfg>::THREADS)
    ragged_dot_f32_tma(const __grid_constant__ CUtensorMap lhs_map,
                       const __grid_constant__ CUtensorMap rhs_map,
                       const int* __restrict__ gs, float* __restrict__ out,
                       int M, int K, int N, int G, long long items) {
    using C = F32Cfg;
    using R = Ring<C>;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    __shared__ Item meta[STAGES];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], C::CONSUMER_WARPS);
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (warp == C::CONSUMER_WARPS) {
        produce<C, TB>(&lhs_map, &rhs_map, gs, M, K, N, G, items, smem, full,
                       empty, meta);
        return;
    }
    const int nkb = (K + C::BK - 1) / C::BK;
    // -- the float32 consumers
    // rows warp * 8 + ty * 4 + i; columns tx * 4 + j and 64 + tx * 4 + j, or
    // under TB tx + 16 j (below)
    const int ty = lane >> 4, tx = lane & 15;
    const int r_in = warp * 8 + ty * 4;
    RingState r;
    for (;;) {
        mbar_wait(&full[r.s], r.phase);
        const Item it = meta[r.s];
        if (it.row0 >= it.row1) return;
        if (it.group < 0) {
            store_zero_rows<C>(out, it, N);
            release(&empty[r.s], lane);
            r.next();
            continue;
        }
        const bool busy = warp * 8 < it.row1 - it.row0;
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        for (int kb = 0; kb < nkb; ++kb) {
            if (kb > 0) mbar_wait(&full[r.s], r.phase);
            if (busy) {
                const float* As = reinterpret_cast<const float*>(
                    smem + r.s * R::STAGE_BYTES);  // [BM][BK]
                const float* Bs = As + BM * C::BK;  // [BK][BN]
#pragma unroll
                for (int k4 = 0; k4 < C::BK; k4 += 4) {
                    float4 a[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a[i] = *reinterpret_cast<const float4*>(
                            As + (r_in + i) * C::BK + k4);
                    if (TB) {
                        // Bs is [BN][BK] in the 128-byte swizzle: column c's
                        // k4 .. k4 + 3 are 16-byte chunk (k4 / 4) ^ (c % 8)
                        // of its 128-byte row. Columns tx + 16 j: the eight
                        // lanes of a quarter warp read eight chunks of one
                        // swizzle phase, no bank conflict.
                        float4 bt[8];
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            bt[j] = *reinterpret_cast<const float4*>(
                                Bs + (tx + 16 * j) * C::BK +
                                (((k4 >> 2) ^ (tx & 7)) << 2));
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
#pragma unroll
                            for (int i = 0; i < 4; ++i) {
                                const float av = q == 0   ? a[i].x
                                                 : q == 1 ? a[i].y
                                                 : q == 2 ? a[i].z
                                                          : a[i].w;
#pragma unroll
                                for (int j = 0; j < 8; ++j) {
                                    const float bv = q == 0   ? bt[j].x
                                                     : q == 1 ? bt[j].y
                                                     : q == 2 ? bt[j].z
                                                              : bt[j].w;
                                    acc[i][j] = fmaf(av, bv, acc[i][j]);
                                }
                            }
                        }
                    } else {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            const float* brow =
                                Bs + (k4 + q) * C::BN + tx * 4;
                            const float4 b0 =
                                *reinterpret_cast<const float4*>(brow);
                            const float4 b1 =
                                *reinterpret_cast<const float4*>(brow + 64);
                            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                            for (int i = 0; i < 4; ++i) {
                                const float av = q == 0   ? a[i].x
                                                 : q == 1 ? a[i].y
                                                 : q == 2 ? a[i].z
                                                          : a[i].w;
#pragma unroll
                                for (int j = 0; j < 8; ++j)
                                    acc[i][j] = fmaf(av, bv[j], acc[i][j]);
                            }
                        }
                    }
                }
            }
            release(&empty[r.s], lane);
            r.next();
        }
        if (!busy) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = it.row0 + r_in + i;
            if (row >= it.row1) continue;
            if (TB) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int col = it.n0 + tx + 16 * j;
                    if (col < N) out[(size_t)row * N + col] = acc[i][j];
                }
                continue;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = it.n0 + h * 64 + tx * 4;
                if (col < N)
                    *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                        make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
            }
        }
    }
    // -- end of the float32 consumers
}

// ------------------------------------------- the simple kernels (no TMA)

constexpr int BN_S = 64;

template <typename T>
__device__ void zero_rows(T* __restrict__ out, int row0, int row1, int n0,
                          int N) {
    for (int e = threadIdx.x; e < BM * BN_S; e += blockDim.x) {
        const int row = row0 + e / BN_S, col = n0 + e % BN_S;
        if (row < row1 && col < N) out[(size_t)row * N + col] = T(0.0f);
    }
}

constexpr int BK16 = 32;
constexpr int LDA16 = BK16 + 8;  // 80-byte rows: 32-byte aligned WMMA
constexpr int LDB16 = BN_S + 8;  // fragments
constexpr int LDC = BN_S + 4;

__global__ void __launch_bounds__(128) ragged_dot_bf16_simple(
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
    if (threadIdx.x < 32) {
        Cursor c;
        const Tile t = find_tile(gs, G, M, blockIdx.x, c);
        if (threadIdx.x == 0) tile = t;
    }
    __syncthreads();
    const int row0 = tile.row0, row1 = tile.row1, g = tile.group;
    if (row0 >= row1) return;
    const int n0 = blockIdx.y * BN_S;
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
        for (int e = threadIdx.x; e < BM * BK16; e += 128) {
            const int r = e / BK16, kc = e % BK16;
            const int row = row0 + r, kk = k0 + kc;
            As[r * LDA16 + kc] =
                row < row1 && kk < K ? lhs[(size_t)row * K + kk] : zero;
        }
        for (int e = threadIdx.x; e < BK16 * BN_S; e += 128) {
            const int r = e / BN_S, nc = e % BN_S;
            const int kk = k0 + r, col = n0 + nc;
            Bs[r * LDB16 + nc] =
                kk < K && col < N ? B[(size_t)kk * N + col] : zero;
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
    for (int e = threadIdx.x; e < BM * BN_S; e += 128) {
        const int r = e / BN_S, c = e % BN_S;
        const int row = row0 + r, col = n0 + c;
        if (row < row1 && col < N)
            out[(size_t)row * N + col] = __float2bfloat16_rn(Cs[r * LDC + c]);
    }
}

constexpr int BK32 = 16;

__global__ void __launch_bounds__(256) ragged_dot_f32_simple(
    const float* __restrict__ lhs,  // [M, K]
    const float* __restrict__ rhs,  // [G, K, N]
    const int* __restrict__ gs,     // [G]
    float* __restrict__ out,        // [M, N]
    int M, int K, int N, int G) {
    __shared__ Tile tile;
    __shared__ float As[BK32][BM + 4];  // transposed: [k][m]
    __shared__ float Bs[BK32][BN_S + 4];
    if (threadIdx.x < 32) {
        Cursor c;
        const Tile t = find_tile(gs, G, M, blockIdx.x, c);
        if (threadIdx.x == 0) tile = t;
    }
    __syncthreads();
    const int row0 = tile.row0, row1 = tile.row1, g = tile.group;
    if (row0 >= row1) return;
    const int n0 = blockIdx.y * BN_S;
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
            const int row = row0 + r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int kk = k0 + kc + q;
                As[kc + q][r] =
                    row < row1 && kk < K ? lhs[(size_t)row * K + kk] : 0.0f;
            }
        }
        {  // rhs tile: BK32 x BN_S, 4 along n per thread
            const int r = threadIdx.x >> 4, nc = (threadIdx.x & 15) * 4;
            const int kk = k0 + r;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = n0 + nc + q;
                Bs[r][nc + q] =
                    kk < K && col < N ? B[(size_t)kk * N + col] : 0.0f;
            }
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

// ------------------------------------------------------------- launchers

// lhs [M, K] as a 2-D map (K inner) in BM x BK boxes; rhs [G, K, N] as a
// 3-D map (N inner, then K, then G) in B_BOX_N x BK x 1 boxes, or under
// `trans` rhs stored [G, N, K] (K inner: the reduction) in BK x B_BOX_N x 1
// boxes. bf16 takes the 128-byte swizzle wgmma reads; float32 none for lhs
// and the forward's rhs (its consumers read rows) and the 128-byte one for
// the transposed rhs (its consumers read columns: the swizzle spreads them
// over the banks).
template <class C>
int encode_maps(const void* lhs, const void* rhs, int m, int k, int n, int g,
                bool trans, CUtensorMap* a_map, CUtensorMap* b_map) {
    const bool bf16 = sizeof(typename C::T) == 2;
    const CUtensorMapDataType dt = bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapSwizzle sw =
        C::SWIZZLE ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
    const CUtensorMapSwizzle b_sw =
        trans ? CU_TENSOR_MAP_SWIZZLE_128B : sw;
    const cuuint64_t el = sizeof(typename C::T);
    const cuuint32_t ones[3] = {1, 1, 1};
    const cuuint64_t a_dim[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t a_str[1] = {(cuuint64_t)k * el};
    const cuuint32_t a_box[2] = {(cuuint32_t)C::BK, (cuuint32_t)BM};
    const cuuint64_t inner = trans ? k : n, outer = trans ? n : k;
    const cuuint64_t b_dim[3] = {inner, outer, (cuuint64_t)g};
    const cuuint64_t b_str[2] = {inner * el, inner * outer * el};
    const cuuint32_t b_box[3] = {
        (cuuint32_t)(trans ? C::BK : C::B_BOX_N),
        (cuuint32_t)(trans ? C::B_BOX_N : C::BK), 1};
    CUresult r = cuTensorMapEncodeTiled(
        a_map, dt, 2, const_cast<void*>(lhs), a_dim, a_str, a_box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    r = cuTensorMapEncodeTiled(
        b_map, dt, 3, const_cast<void*>(rhs), b_dim, b_str, b_box, ones,
        CU_TENSOR_MAP_INTERLEAVE_NONE, b_sw,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class C, typename K>
int launch_tma(K kernel, int* cache, const void* lhs, const void* rhs,
               const int* gs, void* out, int m, int k, int n, int g,
               bool trans, cudaStream_t st) {
    CUtensorMap a_map, b_map;
    int err = encode_maps<C>(lhs, rhs, m, k, n, g, trans, &a_map, &b_map);
    if (err) return err;
    const int ctas =
        persistent_ctas(kernel, Ring<C>::THREADS, Ring<C>::SMEM, cache);
    if (ctas < 0) return -ctas;
    const long long items =
        ((m + BM - 1LL) / BM + g + 1) * ((n + C::BN - 1LL) / C::BN);
    const int grid = (int)(items < ctas ? items : ctas);
    kernel<<<grid, Ring<C>::THREADS, Ring<C>::SMEM, st>>>(
        a_map, b_map, gs, (typename C::T*)out, m, k, n, g, items);
    return (int)cudaGetLastError();
}

// persistent grid sizes, per kernel (forward, transposed) and device
int bf16_ctas[2][64], f32_ctas[2][64];

}  // namespace

// lhs [M, K], out [M, N]; rhs [G, K, N], or with trans = 1 rhs stored
// [G, N, K] and read transposed (out = lhs @ rhs[g]^T: K6's data gradient,
// with no transposed copy). bf16: 1 for bfloat16, 0 for float32. vec: the
// TMA path (K and N are multiples of the 16-byte vector, 8 bf16 or 4
// float32, K and G are positive and lhs and rhs are 16-byte aligned); else
// the simple kernels, which take no trans.
extern "C" int ragged_dot_launch(
    const void* lhs, const void* rhs, const void* group_sizes, void* out,
    int m, int k, int n, int g, int bf16, int vec, int trans, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    if (k < 0 || g < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int* gs = (const int*)group_sizes;
    if (vec) {
        if (k == 0 || g == 0) return (int)cudaErrorInvalidValue;
        const DeviceOf dev(lhs);  // until the launch has returned
        if (dev.err != cudaSuccess) return (int)dev.err;
        if (bf16)
            return trans ? launch_tma<Bf16Cfg>(
                               ragged_dot_bf16_tma<true>, bf16_ctas[1], lhs,
                               rhs, gs, out, m, k, n, g, true, st)
                         : launch_tma<Bf16Cfg>(
                               ragged_dot_bf16_tma<false>, bf16_ctas[0], lhs,
                               rhs, gs, out, m, k, n, g, false, st);
        return trans ? launch_tma<F32Cfg>(ragged_dot_f32_tma<true>,
                                          f32_ctas[1], lhs, rhs, gs, out, m,
                                          k, n, g, true, st)
                     : launch_tma<F32Cfg>(ragged_dot_f32_tma<false>,
                                          f32_ctas[0], lhs, rhs, gs, out, m,
                                          k, n, g, false, st);
    }
    if (trans) return (int)cudaErrorInvalidValue;
    const long long tiles_m = (m + BM - 1LL) / BM + g + 1;
    const long long tiles_n = (n + BN_S - 1LL) / BN_S;
    if (tiles_m > 0x7FFFFFFFLL || tiles_n > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles_m, (unsigned)tiles_n);
    if (bf16)
        ragged_dot_bf16_simple<<<grid, 128, 0, st>>>(
            (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs, gs,
            (__nv_bfloat16*)out, m, k, n, g);
    else
        ragged_dot_f32_simple<<<grid, 256, 0, st>>>(
            (const float*)lhs, (const float*)rhs, gs, (float*)out, m, k, n,
            g);
    return (int)cudaGetLastError();
}
