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
//   * pass p takes a segment's queries p*512 .. p*512+511 (the Pallas query
//     block), as the reference's passes over the queries that overflow a
//     tile's block. One launch runs the passes [pass_lo, pass_hi): each
//     entry is written by the pass that owns it, and compare-count does not
//     depend on the pass, so the output equals those passes run in order;
//   * the slot array is read as stored (int64, no padding); the last,
//     partial tile is treated as padded with int64 max, as the adapter pads
//     it, so a query equal to int64 max counts that padding too.
// Compare-count, not bisection: the two agree only on a sorted tile, and
// the Pallas kernel does not require one. So every key of every touched
// tile is read.
//
// What bounds it on the H100: the tiles' bytes, once the count is spread.
// A 4096-query route batch over a 10.5M-key slot array touches about 2,300
// distinct 16 KB tiles (38 MB, 0.0114 ms at 3.35 TB/s) with one or two
// queries each, but every query above the key domain predicts the last
// tile, so one segment holds about a thousand queries. A count is 2048
// compares per query, about 128 cycles of one SM's shared-memory bandwidth;
// a design that gives each segment to one CTA spends 0.068 ms on that
// CTA's 512-query count while the rest of the card idles (H100 80GB HBM3
// at 700 W, kernel_ab.py). The design:
//   * work split by queries, not by segments: a grid of as many 128-thread
//     CTAs as fit on the card (about six per SM at two 16 KB stages each),
//     CTA b takes an equal share of the tile-sorted queries, finds the
//     segment of its first one by a 32-ary search over seg_start, and
//     walks the segments its share overlaps. A segment of many queries is
//     counted by many CTAs, each bringing the same tile (from L2 after the
//     first); queries outside the requested passes are skipped;
//   * a TMA 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes)
//     per tile, two stages: while the CTA counts one tile, its next tile is
//     already on its way into the other buffer. A bulk copy rather than
//     16-byte cp.async because one thread issues the whole 16 KB and no
//     register or instruction of the counting warps is spent on the copy.
//     The copy needs 16-byte alignment and a multiple of 16 bytes, so it
//     starts at the first 16-byte boundary of the tile (a slot array that
//     is only 8-byte aligned leaves one head key) and covers an even
//     number of valid keys; the threads load the head and an odd tail key
//     by hand and fill the padding of a partial last tile with int64 max;
//   * a warp per query: lane l compares tile[l + 32 k], k = 0..63 (no bank
//     conflicts) into four sums, __reduce_add_sync adds the lanes, lane 0
//     writes. The warps of a CTA take its queries of a segment in turn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kQBlk = 512;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
// a tile plus one key of head room for an 8-byte-aligned slot array,
// rounded up to 16 bytes
constexpr int kBufKeys = kTile + 2;
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ uint32_t smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
    }
}

// Keys of a tile that are in the slot array (<= 0 for a tile past its end).
__device__ __forceinline__ long long valid_keys(long long t0, long long cap) {
    const long long v = cap - t0;
    return v < kTile ? v : kTile;
}

// Keys the bulk copy brings: an even count from the first 16-byte boundary.
__device__ __forceinline__ long long bulk_keys(long long nvalid, int head) {
    const long long nb = (nvalid - head) & ~1LL;
    return nb > 0 ? nb : 0;
}

// The first index f in [0, n_seg] with seg_start[f] > x, by a 32-ary search
// over the (non-decreasing) segment starts; seg_start[n_seg] = n > x. One
// warp, every lane gets the answer.
__device__ __forceinline__ int first_start_above(
    const long long* __restrict__ seg_start, int n_seg, long long x,
    int lane) {
    int lo = 0;
    int hi = n_seg;
    while (lo < hi) {  // the same for every lane
        const int step = (hi - lo + 32) >> 5;
        int at = lo + (lane + 1) * step - 1;
        at = at < hi ? at : hi;
        const int below = __popc(__ballot_sync(0xFFFFFFFFu,
                                               seg_start[at] <= x));
        const int nlo = lo + below * step;
        const int nhi = nlo + step - 1;
        lo = nlo < hi ? nlo : hi;
        hi = nhi < hi ? nhi : hi;
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads) tile_search_kernel(
    const long long* __restrict__ slots,      // [cap]
    const long long* __restrict__ queries,    // [n], sorted by tile
    const long long* __restrict__ seg_tile,   // [n_seg]
    const long long* __restrict__ seg_start,  // [n_seg + 1]
    int32_t* __restrict__ out,                // [n], these passes' entries
    int n_seg, long long n, long long cap, int pass_lo, int pass_hi,
    long long per_cta) {
    __shared__ __align__(16) long long buf[kStages][kBufKeys];
    __shared__ __align__(8) uint64_t full[kStages];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    // keys before the slot array's first 16-byte boundary (0 or 1); tiles
    // start 16 KB apart, so it is the same for every tile
    const int head = (int)((reinterpret_cast<uintptr_t>(slots) >> 3) & 1);
    const long long qlo = (long long)pass_lo * kQBlk;
    const long long qhi = (long long)pass_hi * kQBlk;
    // this CTA's share of the tile-sorted queries
    const long long start = (long long)blockIdx.x * per_cta;
    const long long end = start + per_cta < n ? start + per_cta : n;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem(&full[s])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the segment of query `start` (every warp finds the same)
    const int g0 = first_start_above(seg_start, n_seg, start, lane) - 1;
    __syncthreads();

    // segment g's queries in this CTA's share and in the passes: [a, b)
    auto overlap = [&](int g, long long& a, long long& b) {
        const long long s0 = seg_start[g];
        const long long s1 = seg_start[g + 1];
        a = s0 + qlo > start ? s0 + qlo : start;
        b = s0 + qhi < s1 ? s0 + qhi : s1;
        b = b < end ? b : end;
        return a < b;
    };
    // the first segment at or after g with queries in the share and the
    // passes (n_seg when there is none); every thread computes the same
    auto next_active = [&](int g) {
        long long a, b;
        for (; g < n_seg && seg_start[g] < end; ++g)
            if (overlap(g, a, b)) return g;
        return n_seg;
    };
    // one thread: start segment g's tile into stage s
    auto issue = [&](int g, int s) {
        const long long t0 = seg_tile[g] * kTile;
        const long long nb = bulk_keys(valid_keys(t0, cap), head);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem(&full[s])), "r"((uint32_t)(nb * 8))
                     : "memory");
        if (nb > 0)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];\n"
                :: "r"(smem(&buf[s][2 * head])), "l"(slots + t0 + head),
                   "r"((uint32_t)(nb * 8)), "r"(smem(&full[s]))
                : "memory");
    };

    int cur = next_active(g0 > 0 ? g0 : 0);
    if (cur < n_seg && threadIdx.x == 0) issue(cur, 0);
    int s = 0;
    uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait on
    while (cur < n_seg) {
        const int nxt = next_active(cur + 1);
        if (nxt < n_seg && threadIdx.x == 0) issue(nxt, s ^ 1);

        long long lo, hi;
        overlap(cur, lo, hi);
        long long i = lo + warp;
        long long q = i < hi ? queries[i] : 0;  // in flight during the wait

        bar_wait(&full[s], (parity >> s) & 1);
        parity ^= 1u << s;

        // tile key k lives at tile[k]; the keys the bulk copy left out
        long long* tile = buf[s] + head;
        const long long t0 = seg_tile[cur] * kTile;
        const long long nvalid = valid_keys(t0, cap);
        const int nb = (int)bulk_keys(nvalid, head);
        const int fill = kTile - nb;  // the same for every thread
        if (fill > 0) {
            for (int j = threadIdx.x; j < fill; j += kThreads) {
                const int k = j < head ? j : nb + j;
                tile[k] = k < nvalid ? slots[t0 + k] : kKeyMax;
            }
            // order these writes before a later bulk copy into the buffer
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
        }

        for (; i < hi; i += kWarps) {
            const long long qn = i + kWarps < hi ? queries[i + kWarps] : 0;
            // four sums, so the adds are not one chain of 64
            unsigned c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
            for (int k = 0; k < kTile / 32; k += 4) {
                c0 += tile[lane + 32 * k] <= q;
                c1 += tile[lane + 32 * (k + 1)] <= q;
                c2 += tile[lane + 32 * (k + 2)] <= q;
                c3 += tile[lane + 32 * (k + 3)] <= q;
            }
            const unsigned c = __reduce_add_sync(0xFFFFFFFFu, c0 + c1 + c2 + c3);
            if (lane == 0) out[i] = (int32_t)c - 1;
            q = qn;
        }
        __syncthreads();  // every warp is done with stage s before its refill
        cur = nxt;
        s ^= 1;
    }
}

// The grid: SMs times the CTAs that fit on one (asked once per
// device, with the shared-memory carveout at its maximum).
long long grid_for(int device) {
    static long long cache[64];
    long long& g = cache[device & 63];
    if (g == 0) {
        cudaFuncSetAttribute(tile_search_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, tile_search_kernel, kThreads, 0);
        g = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    }
    return g;
}

}  // namespace

extern "C" int tile_search_launch(
    const void* slots, const void* queries, const void* seg_tile,
    const void* seg_start, void* out, int n_seg, long long n, long long cap,
    int pass_lo, int pass_hi, void* stream) {
    if (n_seg <= 0 || n <= 0 || pass_lo >= pass_hi) return 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const long long ctas = grid_for(device);
    const long long per_cta = (n + ctas - 1) / ctas;
    const int blocks = (int)((n + per_cta - 1) / per_cta);
    tile_search_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)slots, (const long long*)queries,
        (const long long*)seg_tile, (const long long*)seg_start,
        (int32_t*)out, n_seg, n, cap, pass_lo, pass_hi, per_cta);
    return (int)cudaGetLastError();
}
