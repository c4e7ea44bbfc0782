// K2 — BMAT rank: the bias query r(k) of Definition 1, searchsorted-left
// over the packed sorted BMAT keys, through the two-level fence tree.
//
// Replaces the TPU kernel bmat_rank_offset_pallas
// (src/repro/kernels/bmat_rank.py). Same function: the first fence >= q
// (the fences are every fanout-th key plus a trailing KEY_MAX), then the
// first key >= q inside the located node (f - 1, f], then min(rank, cap),
// shard-local. The BMAT keeps its keys packed and sorted with KEY_MAX
// padding, so any exact search that finds the same fence and the same key
// gives the Pallas kernel's and both plain traversals' answer (RBMAT
// descent, B+MAT fences); the reference bisects, this kernel does not.
// Queries may carry a shard id, from which the kernel derives the flat key
// and fence bases (kbase = sid * cap, fbase = sid * nf), so S stacked BMATs
// rank in one launch; a single BMAT passes a null sid (shard 0).
//
// What bounds it on the H100: neither bytes nor operations (a 4096-query
// batch reads about 0.2 MB), but the chain of dependent reads from L2, and
// below that the launch itself. A bisect per thread walks
// ceil(log2(nf + 1)) + ceil(log2(fanout + 1)) reads one after another
// (20 on the main path's BMAT: nf 16,385, fanout 16) in 16 CTAs. The
// design cuts the chain and fills the card:
//   * a warp per query, 8 queries per 256-thread CTA (512 CTAs for 4096
//     queries);
//   * a 32-ary search over the fences: the warp holds the range [lo, hi]
//     of the first fence >= q; each round lane l reads the fence at
//     lo + (l + 1) * step - 1 (clamped to hi), step = ceil((hi - lo + 1) /
//     32), and __popc(__ballot_sync(fence < q)) narrows the range to one
//     step, until it holds one fence: ceil(log32 nf) dependent reads;
//   * for fanout <= 64, one round over the node [node_lo, min(node_lo +
//     fanout, kend)): the lanes read its keys (one each for fanout <= 32,
//     two for 64) and __popc(__ballot_sync(key < q)) is the rank inside it;
//   * for a wider node, a 32-ary count over it: while more than 32 keys
//     are left, lane l reads the last key of the l-th of 32 equal chunks
//     and the ballot of those < q names the one chunk where the keys pass
//     q (its last key, >= q, drops out); then one round counts the rest.
//     That is ceil(log32 fanout) dependent reads (2 up to fanout 1024),
//     one key per lane each. Reading the whole node in 32-key chunks
//     instead would be one round, but fanout / 32 loads per lane (32 at
//     fanout 1024, 8 KB a query), where the search reads 512 bytes;
//   * the arrays are read through the read-only path.
// So a query takes ceil(log32 nf) + 1 dependent reads (4 on the main
// path's BMAT: fanout 16) instead of 20, and ceil(log32 nf) +
// ceil(log32 fanout) above fanout 64. What is left is L2 latency and the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRoundFanout = 64;  // the node round reads two keys per lane
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) bmat_rank_kernel(
    const long long* __restrict__ keys,     // [S * cap]
    const long long* __restrict__ fences,   // [S * nf]
    const long long* __restrict__ queries,  // [n]
    const long long* __restrict__ sid,      // [n], or null: all shard 0
    long long* __restrict__ out,            // [n]
    int n, int cap, int nf, int fanout) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i >= n) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    const long long q = __ldg(queries + i);
    const long long s_id = sid ? __ldg(sid + i) : 0;
    const long long kbase = s_id * (long long)cap;
    const long long fbase = s_id * (long long)nf;

    // 1. the first fence >= q lies in [lo, hi]
    long long lo = fbase;
    long long hi = fbase + (nf - 1);
    while (lo < hi) {  // the same for every lane
        const long long step = (hi - lo + 32) >> 5;
        long long at = lo + (lane + 1) * step - 1;
        at = at < hi ? at : hi;
        const int below = __popc(__ballot_sync(kFull,
                                               __ldg(fences + at) < q));
        // the probes are sorted, so `below` of them lie under q; lane 31
        // probes hi, which is >= q
        const long long nlo = lo + below * step;
        const long long nhi = nlo + step - 1;
        lo = nlo < hi ? nlo : hi;
        hi = nhi < hi ? nhi : hi;
    }

    // 2. the rank inside node (f - 1, f]
    const long long f = lo - fbase - 1;
    const long long node_lo = kbase + (f > 0 ? f : 0) * fanout;
    const long long kend = kbase + cap;
    const long long node_hi = node_lo + fanout < kend ? node_lo + fanout : kend;
    long long r;
    if (fanout <= kRoundFanout) {  // the same for every lane
        const long long k0 = node_lo + lane;
        const long long k1 = k0 + 32;
        const bool lt0 = k0 < node_hi && __ldg(keys + k0) < q;
        const bool lt1 = k1 < node_hi && __ldg(keys + k1) < q;
        r = node_lo - kbase
            + __popc(__ballot_sync(kFull, lt0))
            + __popc(__ballot_sync(kFull, lt1));
    } else {
        // the rank is a + the count of keys < q in [a, z)
        long long a = node_lo;
        long long z = node_hi;
        while (z - a > 32) {  // the same for every lane
            const long long step = (z - a + 31) >> 5;
            const long long first = a + lane * step;  // of chunk `lane`
            long long last = first + step - 1;
            last = last < z - 1 ? last : z - 1;
            // the chunks are sorted, so the `below` ones < q come first
            const int below = __popc(__ballot_sync(
                kFull, first < z && __ldg(keys + last) < q));
            const long long na = a + below * step;
            if (na >= z) {  // every key of the node is < q
                a = z;
                break;
            }
            // chunk `below` holds the first key >= q; its last key is one
            a = na;
            z = (na + step < z ? na + step : z) - 1;
        }
        if (a < z) {
            const long long at = a + lane;
            a += __popc(__ballot_sync(kFull, at < z && __ldg(keys + at) < q));
        }
        r = a - kbase;
    }
    if (lane == 0) out[i] = r < cap ? r : cap;
}

}  // namespace

extern "C" int bmat_rank_launch(
    const void* keys, const void* fences, const void* queries,
    const void* sid, void* out, int n, int cap, int nf, int fanout,
    void* stream) {
    if (n <= 0) return 0;
    if (fanout < 1 || nf < 1 || cap < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (n + kWarps - 1) / kWarps;
    bmat_rank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const long long*)fences,
        (const long long*)queries, (const long long*)sid, (long long*)out,
        n, cap, nf, fanout);
    return (int)cudaGetLastError();
}
