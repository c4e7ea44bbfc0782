// K1 — fused locate: radix predict + knot search + interpolation + bounded
// 3-row window search over the slot keys, one launch per query batch.
//
// Replaces the TPU kernel fused_locate_pallas
// (src/repro/kernels/spline_lookup.py). Same function, per query:
//   1. radix bucket b = clip(key >> shift, 0, n_buckets - 1), any shift in
//      [0, 63]; keys above the trained domain saturate to the last bucket;
//   2. rs_iters steps of knot bisect inside the bucket's knot range
//      [lo, hi] (lo = max(table[b], 1) - 1, hi = min(table[b + 1], K - 2));
//   3. float32 interpolation from (hi, lo)-split key deltas, IEEE division,
//      and the lerp as one fused multiply-add (the TPU kernel's reference
//      run contracts it the same way); the float64 knot positions are
//      rounded to float32 in registers;
//   4. round half to even, clamp, span start ((c / W) - 1) * W clipped to
//      [0, cap - L] with L = min(3W, cap);
//   5. ceil(log2 L) steps of bisect over the slot keys in the span.
// Output per query: shard-local j (last slot with key <= q in the span, or
// start - 1) and the span start, both int64.
//
// Float32 positions are exact only up to 2^24 slots. Above that the JAX
// package leaves the TPU kernel for its float64 spline path; with interp64
// set, step 3 is that path's arithmetic instead (int64 deltas converted to
// float64, separate multiply and add), so the same kernel serves any
// capacity.
//
// Keys are int64 in device memory; the comparisons are native int64, which
// orders the non-negative key domain and the KEY_MAX padding exactly as
// the TPU kernel's (hi, lo) pairs do. Queries may carry a shard id, from
// which the kernel derives the flat table / knot / slot bases, so S stacked
// shards run in one launch; a null sid means shard 0 for every query.
//
// Why counting equals the bisects. A bisect over [lo, hi] that converges
// (hi - lo + 1 <= 2^iters) ends at lo + count(a[lo + 1 .. hi] <= q) when
// a is sorted: the keys <= q are a prefix, and the bisect finds its end.
//   * Knots are non-decreasing within a shard (increasing, then copies of
//     the last knot as padding), and the index sizes rs_iters so the
//     knot bisect always converges on its own model. The kernel's contract
//     is still the bisect for any rs_iters: a query whose knot range is
//     wider than 2^rs_iters (or than one round of 32 lanes) runs the
//     reference's bisect itself, warp-uniformly, on the card.
//   * Slot keys are non-decreasing within a shard (the fill-forward
//     invariant: empty slots repeat their left neighbour's key, the tail
//     is KEY_MAX, deletes tombstone the values only), so the span bisect,
//     with its `below` test, gives j = start - 1 + count(span <= q).
//
// What bounds it on the H100: neither bytes (a 4096-query batch needs about
// 0.5 MB) nor operations, but the chain of dependent reads per query, and
// below that the launch. The first design ran one thread per query in 16
// CTAs (4096 queries), and each query walked about 15 dependent 8-byte
// reads: the query, the table, rs_iters (4 on the main path) knot steps,
// the interpolation's two knots, then ceil(log2 L) (8 for L = 192) span
// steps. This design cuts the chain to 5 and fills the card:
//   * a warp per query, 8 queries per 256-thread CTA (512 CTAs for 4096
//     queries); every ballot and shuffle uses the full mask, every array is
//     read through the read-only path;
//   * the knot search is one round: lane l reads knots[lo + l] and
//     knot_pos[lo + l] (the range and the knot after it), the ballot of
//     the lanes 1 .. hi - lo with knots <= q counts the segment s, and the
//     interpolation's two knots and positions come from lanes s - lo and
//     s - lo + 1 by shuffles, with no further read;
//   * the span search is two rounds: the span is cut into chunks of G = 32
//     keys on 256-byte boundaries of the address space (two lines; a larger
//     power of two when L > 31 chunks), round 1 reads the last key of every
//     chunk it touches (7 probes for L = 192), the ballot of those <= q
//     names the chunk where the keys pass q, and round 2 counts that
//     chunk's keys, one per lane.
// Chain: query, table, knots, span probes, span chunk (plus the shard id
// and its shift for stacked shards): 5 dependent reads instead of 15,
// touching about 7 + 8 sectors of the span instead of 8. Measured against
// one-line chunks (13 probes, then one line) and against reading the whole
// span in one round (48 sectors, 4 dependent reads), two-line chunks were
// the fastest with the L2 flushed, which is how a main-path wave finds its
// spans; the one-round read is faster only while the spans sit in the L2
// (k1_variants.py; PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_delta.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads) fused_locate_kernel(
    const int32_t* __restrict__ table,       // [S * n_table]
    const long long* __restrict__ knots,     // [S * n_knots]
    const double* __restrict__ knot_pos,     // [S * n_knots]
    const int32_t* __restrict__ shift,       // [S]
    const long long* __restrict__ slots,     // [S * cap]
    const long long* __restrict__ queries,   // [n]
    const long long* __restrict__ sid,       // [n], or null: all shard 0
    long long* __restrict__ j_out,           // [n]
    long long* __restrict__ start_out,       // [n]
    int n, int n_table, int n_knots, int cap, int window, int L,
    int rs_iters, int chunk_log2, int interp64) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i >= n) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    const long long q = __ldg(queries + i);
    const long long s_id = sid ? __ldg(sid + i) : 0;
    const long long tb = s_id * n_table;
    const long long sb = s_id * n_knots;
    const long long slb = s_id * (long long)cap;

    // 1. radix bucket
    const int sh = __ldg(shift + s_id);
    const long long n_buckets = n_table - 2;
    long long b = q >> sh;
    b = b < 0 ? 0 : (b > n_buckets - 1 ? n_buckets - 1 : b);

    // 2. knot search in flat coordinates: the bisect's candidates [lo, hi]
    const int t0 = __ldg(table + tb + b);
    const int t1 = __ldg(table + tb + b + 1);
    long long lo = sb + (t0 > 1 ? t0 : 1) - 1;
    long long hi = sb + (t1 < 0 ? 0 : (t1 > n_knots - 2 ? n_knots - 2 : t1));
    const long long width = hi - lo + 1;
    // the widest range that rs_iters steps reduce to one candidate, up to
    // the 32 lanes of one round
    const long long converges =
        rs_iters >= 5 ? 32 : 1LL << (rs_iters > 0 ? rs_iters : 0);
    long long s, k0, k1;
    double p0, p1;
    if (width >= 0 && width <= converges) {  // the same for every lane
        // one round over knots[lo .. hi + 1] (at most 32 of them)
        const int nread = width < 32 ? (int)width + 1 : 32;
        long long kv = 0;
        double pv = 0.0;
        if (lane < nread) {
            kv = __ldg(knots + lo + lane);
            pv = __ldg(knot_pos + lo + lane);
        }
        const unsigned le = __ballot_sync(kFull, lane >= 1 && lane < width
                                                 && kv <= q);
        s = lo + __popc(le) - sb;
        s = (s < 0 ? 0 : (s > n_knots - 2 ? n_knots - 2 : s)) + sb;
        const int at = (int)(s - lo);
        k0 = __shfl_sync(kFull, kv, at & 31);
        k1 = __shfl_sync(kFull, kv, (at + 1) & 31);
        p0 = __shfl_sync(kFull, pv, at & 31);
        p1 = __shfl_sync(kFull, pv, (at + 1) & 31);
        if (at < 0 || at + 1 >= nread) {  // the clamp left the round
            k0 = __ldg(knots + s);
            k1 = __ldg(knots + s + 1);
            p0 = __ldg(knot_pos + s);
            p1 = __ldg(knot_pos + s + 1);
        }
    } else {
        // the reference's bisect, where it stops before converging
        for (int it = 0; it < rs_iters; ++it) {
            const long long mid = (lo + hi + 1) >> 1;
            const bool go = __ldg(knots + mid) <= q;
            lo = go ? mid : lo;
            hi = go ? hi : mid - 1;
        }
        s = lo - sb;
        s = (s < 0 ? 0 : (s > n_knots - 2 ? n_knots - 2 : s)) + sb;
        k0 = __ldg(knots + s);
        k1 = __ldg(knots + s + 1);
        p0 = __ldg(knot_pos + s);
        p1 = __ldg(knot_pos + s + 1);
    }

    // 3. interpolation, rounded half to even
    long long c;
    if (interp64) {
        const double dk = __ll2double_rn(q - k0);
        const double seg = fmax(__ll2double_rn(k1 - k0), 1.0);
        const double t = fmin(fmax(__ddiv_rn(dk, seg), 0.0), 1.0);
        const double p = __dadd_rn(p0, __dmul_rn(t, __dsub_rn(p1, p0)));
        c = llrint(p);
    } else {
        const float dk = split_delta(q, k0);
        const float seg = split_delta(k1, k0);
        float t = __fdiv_rn(dk, fmaxf(seg, 1.0f));
        t = fminf(fmaxf(t, 0.0f), 1.0f);
        const float f0 = __double2float_rn(p0);
        const float f1 = __double2float_rn(p1);
        c = (long long)rintf(__fmaf_rn(t, __fsub_rn(f1, f0), f0));
    }

    // 4. predicted slot -> 3-row span start
    c = c < 0 ? 0 : (c > cap - 1 ? cap - 1 : c);
    const long long max_start = cap - L > 0 ? cap - L : 0;
    // c < cap < 2^31: a 32-bit division, not the 64-bit routine
    long long start =
        ((long long)((unsigned)c / (unsigned)window) - 1) * window;
    start = start < 0 ? 0 : (start > max_start ? max_start : start);

    // 5. count the span's keys <= q: chunks of G keys on G-key boundaries
    //    of the address space, probed by their last key, then the one chunk
    //    where the keys pass q
    const long long* span = slots + slb + start;
    const int G = 1 << chunk_log2;
    const int off = (int)(((uintptr_t)span >> 3) & (uintptr_t)(G - 1));
    const int m = (off + L - 1) / G + 1;  // chunks the span touches, <= 32
    int p = ((lane + 1) << chunk_log2) - off - 1;
    p = p < L - 1 ? p : L - 1;
    const int passed = __popc(__ballot_sync(kFull, lane < m
                                                   && __ldg(span + p) <= q));
    int cnt = L;
    if (passed < m) {  // the same for every lane
        // the chunks before `passed` hold keys <= q only; its last key is > q
        int e = (passed << chunk_log2) - off;
        e = e > 0 ? e : 0;
        int e_end = ((passed + 1) << chunk_log2) - off - 1;
        e_end = e_end < L - 1 ? e_end : L - 1;
        cnt = e;
        for (; e < e_end; e += 32) {
            const int at = e + lane;
            cnt += __popc(__ballot_sync(kFull, at < e_end
                                               && __ldg(span + at) <= q));
        }
    }
    if (lane == 0) {
        j_out[i] = start - 1 + cnt;
        start_out[i] = start;
    }
}

}  // namespace

extern "C" int fused_locate_launch(
    const void* table, const void* knots, const void* knot_pos,
    const void* shift, const void* slots, const void* queries,
    const void* sid, void* j_out, void* start_out,
    int n, int n_table, int n_knots, int cap, int window, int rs_iters,
    int interp64, void* stream) {
    if (n <= 0) return 0;
    if (window < 1 || cap < 1 || n_knots < 2)
        return (int)cudaErrorInvalidValue;
    const int L = 3 * window < cap ? 3 * window : cap;
    // chunks of G keys, G a power of two from 32 (two 128-byte lines, one
    // key per lane in round 2) up, such that a span at any offset touches at
    // most 32 of them (one probe per lane in round 1)
    int chunk_log2 = 5;
    while (((1 << chunk_log2) + L - 2) / (1 << chunk_log2) + 1 > 32)
        ++chunk_log2;
    const int blocks = (n + kWarps - 1) / kWarps;
    fused_locate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const long long*)knots,
        (const double*)knot_pos, (const int32_t*)shift,
        (const long long*)slots, (const long long*)queries,
        (const long long*)sid, (long long*)j_out, (long long*)start_out,
        n, n_table, n_knots, cap, window, L, rs_iters, chunk_log2, interp64);
    return (int)cudaGetLastError();
}
