// K4 — tile search: for each routed query, the count of keys in its
// 2048-key tile of the slot array that are <= q, minus one (-1 when none
// is), by compare-count.
//
// Replaces the TPU kernel tile_search_pallas
// (src/repro/kernels/tile_search.py). Same function, other layout:
//   * the Pallas kernel takes the slot array cut into (n_tiles, 2048) tiles
//     and a dense (n_tiles, 512) buffer of routed queries, and runs one grid
//     step per tile whether or not a query routed there. This kernel takes
//     the queries already sorted by tile (the adapter's bucketing sorts them
//     anyway) with one segment per tile that holds a query: `seg_tile[g]` is
//     the tile of segment g and `seg_start[g]..seg_start[g+1]` its queries.
//     So it never builds the query buffer, and reads only the tiles that
//     queries route to;
//   * one pass handles at most 512 queries of a segment (the Pallas query
//     block): pass p takes the segment's queries p*512 .. p*512+511, as the
//     reference's passes over the queries that overflow a tile's block;
//   * the slot array is read as stored (int64, no padding); the last,
//     partial tile is treated as padded with int64 max, as the adapter pads
//     it, so a query equal to int64 max counts that padding too.
// Compare-count, not bisection: the two agree only on a sorted tile, and
// the Pallas kernel does not require one.
//
// What bounds it on the H100: the tiles. A batch of 4096 queries spread
// over a 10M-key array routes almost every query to a tile of its own, so
// the kernel reads about 16 KB per query and does 2048 compares per query;
// the bytes set the bound. The design is one CTA per segment: the tile is
// staged once in shared memory (16 KB) and every thread counts for its
// queries over it; all lanes of a warp read the same tile word, which the
// shared memory broadcasts. Empty segments and segments with no queries in
// this pass exit before staging the tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kQBlk = 512;
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;

__global__ void __launch_bounds__(256) tile_search_kernel(
    const long long* __restrict__ slots,      // [cap]
    const long long* __restrict__ queries,    // [n], sorted by tile
    const long long* __restrict__ seg_tile,   // [n_seg]
    const long long* __restrict__ seg_start,  // [n_seg + 1]
    int32_t* __restrict__ out,                // [n], this pass's entries
    long long cap, int pass) {
    const int g = blockIdx.x;
    const long long s1 = seg_start[g + 1];
    const long long lo = seg_start[g] + (long long)pass * kQBlk;
    const long long hi = lo + kQBlk < s1 ? lo + kQBlk : s1;
    if (lo >= hi) return;  // the same for every thread of the block

    __shared__ long long tile[kTile];
    const long long base = seg_tile[g] * kTile;
    for (int k = threadIdx.x; k < kTile; k += blockDim.x) {
        const long long gi = base + k;
        tile[k] = gi < cap ? slots[gi] : kKeyMax;
    }
    __syncthreads();

    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const long long q = queries[i];
        int c = 0;
#pragma unroll 16
        for (int k = 0; k < kTile; ++k) c += tile[k] <= q;
        out[i] = c - 1;
    }
}

}  // namespace

extern "C" int tile_search_launch(
    const void* slots, const void* queries, const void* seg_tile,
    const void* seg_start, void* out, int n_seg, long long cap, int pass,
    void* stream) {
    if (n_seg <= 0) return 0;
    tile_search_kernel<<<n_seg, 256, 0, (cudaStream_t)stream>>>(
        (const long long*)slots, (const long long*)queries,
        (const long long*)seg_tile, (const long long*)seg_start,
        (int32_t*)out, cap, pass);
    return (int)cudaGetLastError();
}
