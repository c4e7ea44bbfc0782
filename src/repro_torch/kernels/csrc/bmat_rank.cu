// K2 — BMAT rank: the bias query r(k) of Definition 1, searchsorted-left
// over the packed sorted BMAT keys, through the two-level fence tree.
//
// Replaces the TPU kernel bmat_rank_offset_pallas
// (src/repro/kernels/bmat_rank.py). Same search, step for step:
//   1. ceil(log2(nf + 1)) steps of bisect over the fence array (every
//      fanout-th key plus a trailing KEY_MAX) for the first fence >= q;
//   2. ceil(log2(fanout + 1)) steps of bisect inside the located node;
//   3. result min(rank, cap), shard-local.
// Queries may carry a shard id, from which the kernel derives the flat key
// and fence bases (kbase = sid * cap, fbase = sid * nf), so S stacked BMATs
// rank in one launch; a single BMAT passes a null sid (shard 0). The search is
// exact integer arithmetic on native int64 keys, so it equals the TPU
// kernel and both plain traversals (RBMAT descent, B+MAT fences) exactly.
//
// What bounds it on the H100: a chain of dependent random 8-byte reads
// (fences, then one node), latency rather than bandwidth. This first design
// is one thread per query in 256-thread blocks, arrays in HBM behind the
// read-only path, the ragged edge masked here. Fences in shared memory and
// sorted queries are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) bmat_rank_kernel(
    const long long* __restrict__ keys,     // [S * cap]
    const long long* __restrict__ fences,   // [S * nf]
    const long long* __restrict__ queries,  // [n]
    const long long* __restrict__ sid,      // [n], or null: all shard 0
    long long* __restrict__ out,            // [n]
    int n, int cap, int nf, int fanout, int fence_iters, int node_iters) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long q = queries[i];
    const long long s_id = sid ? sid[i] : 0;
    const long long kbase = s_id * (long long)cap;
    const long long fbase = s_id * (long long)nf;

    // 1. first fence >= q; mid <= fbase + nf - 1 holds throughout
    long long lo = fbase;
    long long hi = fbase + (nf - 1);
    for (int it = 0; it < fence_iters; ++it) {
        const long long mid = (lo + hi) >> 1;
        const bool go = fences[mid] < q;
        lo = go ? mid + 1 : lo;
        hi = go ? hi : mid;
    }

    // 2. bisect inside node (f - 1, f]
    const long long f = lo - fbase - 1;
    const long long node_lo = kbase + (f > 0 ? f : 0) * fanout;
    const long long kend = kbase + cap;
    const long long kcap = kend - 1;
    long long nlo = node_lo;
    long long nhi = node_lo + fanout < kend ? node_lo + fanout : kend;
    for (int it = 0; it < node_iters; ++it) {
        const long long mid = (nlo + nhi) >> 1;
        const long long midc = mid < kcap ? mid : kcap;
        const bool go = keys[midc] < q;
        nlo = go ? mid + 1 : nlo;
        nhi = go ? nhi : mid;
    }
    const long long r = nlo - kbase;
    out[i] = r < cap ? r : cap;
}

int ceil_log2(int x) {  // ceil(log2 x) for x >= 1
    int k = 0;
    while ((1LL << k) < x) ++k;
    return k;
}

}  // namespace

extern "C" int bmat_rank_launch(
    const void* keys, const void* fences, const void* queries,
    const void* sid, void* out, int n, int cap, int nf, int fanout,
    void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    bmat_rank_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const long long*)fences,
        (const long long*)queries, (const long long*)sid, (long long*)out,
        n, cap, nf, fanout, ceil_log2(nf + 1), ceil_log2(fanout + 1));
    return (int)cudaGetLastError();
}
