// K1 — fused locate: radix predict + knot search + interpolation + bounded
// 3-row window bisect over the slot keys, one launch per query batch.
//
// Replaces the TPU kernel fused_locate_pallas
// (src/repro/kernels/spline_lookup.py). Same arithmetic, step for step:
//   1. radix bucket b = clip(key >> shift, 0, n_buckets - 1), any shift in
//      [0, 63]; keys above the trained domain saturate to the last bucket;
//   2. rs_iters steps of knot bisect inside the bucket's knot range;
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
// What bounds it on the H100: every step is a dependent random 8-byte read
// (table, knots, then slots), so a query's time is a chain of memory
// latencies, not bandwidth. This first design is one thread per query in
// 256-thread blocks with every array read from HBM through the read-only
// path; the ragged edge is masked here, so callers pass unpadded batches.
// Hiding the latency chain (knots in shared memory, warp-per-query-group,
// sorted queries) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_delta.cuh"

namespace {

__global__ void __launch_bounds__(256) fused_locate_kernel(
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
    int rs_iters, int n_bisect, int interp64) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long q = queries[i];
    const long long s_id = sid ? sid[i] : 0;
    const long long tb = s_id * n_table;
    const long long sb = s_id * n_knots;
    const long long slb = s_id * (long long)cap;

    // 1. radix bucket
    const int sh = shift[s_id];
    const long long n_buckets = n_table - 2;
    long long b = q >> sh;
    b = b < 0 ? 0 : (b > n_buckets - 1 ? n_buckets - 1 : b);

    // 2. knot bisect in flat coordinates
    const int t0 = table[tb + b];
    const int t1 = table[tb + b + 1];
    long long lo = sb + (t0 > 1 ? t0 : 1) - 1;
    long long hi = sb + (t1 < 0 ? 0 : (t1 > n_knots - 2 ? n_knots - 2 : t1));
    for (int it = 0; it < rs_iters; ++it) {
        const long long mid = (lo + hi + 1) >> 1;
        const bool go = knots[mid] <= q;
        lo = go ? mid : lo;
        hi = go ? hi : mid - 1;
    }
    long long s = lo - sb;
    s = (s < 0 ? 0 : (s > n_knots - 2 ? n_knots - 2 : s)) + sb;

    // 3. interpolation, rounded half to even
    const long long k0 = knots[s];
    const long long k1 = knots[s + 1];
    long long c;
    if (interp64) {
        const double dk = __ll2double_rn(q - k0);
        const double seg = fmax(__ll2double_rn(k1 - k0), 1.0);
        const double t = fmin(fmax(__ddiv_rn(dk, seg), 0.0), 1.0);
        const double p0 = knot_pos[s];
        const double p = __dadd_rn(
            p0, __dmul_rn(t, __dsub_rn(knot_pos[s + 1], p0)));
        c = llrint(p);
    } else {
        const float dk = split_delta(q, k0);
        const float seg = split_delta(k1, k0);
        float t = __fdiv_rn(dk, fmaxf(seg, 1.0f));
        t = fminf(fmaxf(t, 0.0f), 1.0f);
        const float p0 = __double2float_rn(knot_pos[s]);
        const float p1 = __double2float_rn(knot_pos[s + 1]);
        c = (long long)rintf(__fmaf_rn(t, __fsub_rn(p1, p0), p0));
    }

    // 4. predicted slot -> 3-row span start
    c = c < 0 ? 0 : (c > cap - 1 ? cap - 1 : c);
    const long long max_start = cap - L > 0 ? cap - L : 0;
    long long start = (c / window - 1) * window;
    start = start < 0 ? 0 : (start > max_start ? max_start : start);

    // 5. bounded bisect over the span
    const long long glo = slb + start;
    long long wlo = glo;
    long long whi = glo + (L - 1);
    for (int it = 0; it < n_bisect; ++it) {
        const long long mid = (wlo + whi + 1) >> 1;
        const bool go = slots[mid] <= q;
        wlo = go ? mid : wlo;
        whi = go ? whi : mid - 1;
    }
    const bool below = slots[glo] <= q;
    j_out[i] = below ? wlo - slb : start - 1;
    start_out[i] = start;
}

}  // namespace

extern "C" int fused_locate_launch(
    const void* table, const void* knots, const void* knot_pos,
    const void* shift, const void* slots, const void* queries,
    const void* sid, void* j_out, void* start_out,
    int n, int n_table, int n_knots, int cap, int window, int rs_iters,
    int interp64, void* stream) {
    if (n <= 0) return 0;
    const int L = 3 * window < cap ? 3 * window : cap;
    int n_bisect = 0;
    while ((1 << n_bisect) < L) ++n_bisect;  // ceil(log2 L)
    if (n_bisect < 1) n_bisect = 1;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    fused_locate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const long long*)knots,
        (const double*)knot_pos, (const int32_t*)shift,
        (const long long*)slots, (const long long*)queries,
        (const long long*)sid, (long long*)j_out, (long long*)start_out,
        n, n_table, n_knots, cap, window, L, rs_iters, n_bisect, interp64);
    return (int)cudaGetLastError();
}
