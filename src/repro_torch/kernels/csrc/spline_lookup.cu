// K5 — spline lookup: the batched learned predict. Radix bucket, bounded
// knot bisect and linear interpolation, returning the predicted slot
// position of each query as float32.
//
// Replaces the TPU kernel spline_lookup_pallas
// (src/repro/kernels/spline_lookup.py) and, for radix shifts below 32, the
// plain path its adapter takes instead (ref.spline_lookup_ref, reached from
// src/repro/kernels/ops.py::spline_lookup). The two compute different
// float32 roundings, so the kernel has both, selected by `split`:
//   split = 1 (shift >= 32, the Pallas body):
//     bucket  clip(q_hi >> (shift - 32), 0, n_buckets - 1) from the int32
//             high half of the key;
//     deltas  f32(dhi) * 2^32 + (f32(lo_a) - f32(lo_b)) (key_delta.cuh, the
//             same arithmetic as K1);
//     lerp    one fused multiply-add, as XLA contracts the Pallas body.
//   split = 0 (shift < 32, the reference's plain path):
//     bucket  clip(int32(q >> shift), 0, n_buckets - 1): the cast wraps
//             before the clip, as the reference's astype does;
//     deltas  each int64 difference rounded to float32 once;
//     lerp    a separate multiply and add, as the reference's eager ops.
// Both: n_iters steps of knot bisect inside the bucket's knot range
// [lo, hi] (lo = max(table[b], 1) - 1, hi = clip(table[b + 1], 0, K - 2)),
// IEEE division, t clipped to [0, 1], the float64 knot positions rounded to
// float32 in registers (the adapter's astype).
//
// What bounds it on the H100: neither bytes (a 4096-query batch needs about
// 0.16 MB) nor operations, but the chain of dependent reads per query, and
// below that the launch. The first design ran a thread per query on 16 CTAs
// (4096 queries), each walking the query, the table pair, n_iters knot
// probes one after another and the interpolation's knots and positions.
// This design gives a query a warp, 8 per 256-thread CTA (512 CTAs), and
// cuts the chain to three reads where it can:
//   * one round: where the range holds w = hi - lo + 1 <= 31 knots and the
//     steps left converge on it (w <= 2^steps), lane l reads knots[lo + l]
//     and knot_pos[lo + l] for l <= w (the range and the knot after it),
//     the ballot of lanes 1 .. w - 1 with knots <= q gives the segment
//     s = lo + count, and the interpolation's two knots and positions come
//     from lanes s - lo and s - lo + 1 by shuffles. Chain: query, table,
//     knots.
//   * otherwise, the reference's bisect itself, five steps per round of
//     reads: the next five steps can only probe the 31 mids of a depth-5
//     decision tree, which the lanes read at once (lane l the mid of node
//     l + 1 in heap order, its range replayed from [lo, hi] in registers,
//     and its range after its own step kept); the ballot of their outcomes
//     names the path, and the range after five steps comes by shuffle from
//     the path's node at depth 4 (faster than walking the five steps in
//     registers, k5_variants.py). After each bisect round the rest of the
//     range is looked at again: once it fits the one round, that round ends
//     the search and brings the interpolation's knots with it (the fb
//     index's widest bucket, 794 knots, takes one bisect round, then the
//     round). Where the steps run out or the bisect has converged first
//     (from there on a step leaves lo as it is), one read brings the
//     interpolation's knots.
// Why the round is the bisect. A bisect that converges ends at
// lo + count(knots[lo + 1 .. hi] <= q) whenever the knots <= q come first
// in that range (they do in every spline, whose knots are sorted). The
// kernel checks exactly that on the ballot (its lanes 1 .. w - 1 must be
// a run from lane 1) and takes the round only then, so an unsorted or
// tampered model, a range the steps left cannot converge on, a range wider
// than the round, and lo > hi (a table entry equal to K after the clamp)
// all run the bisect. The bisect rounds repeat the reference's steps, so
// no case depends on sorted knots. A 32-ary ballot search over the range
// takes as many rounds, each with fewer operations, so it is faster on
// ranges wider than the round (k5_variants.py, PERF.md §6), but it equals
// the bisect only on sorted knots, which the kernel cannot check short of
// reading them all; the bisect rounds keep K5 exact on any model.
// K1 (fused_locate.cu) has a knot round of its own: it assumes sorted
// knots and bisects only where the range does not fit. K5 keeps its own
// round so that K1's code and times stay as they were measured.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_delta.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRoundKnots = 31;  // widest range of one round (w + 1 lanes)
constexpr int kTreeDepth = 5;    // bisect steps per round: 31 probes

__global__ void __launch_bounds__(kThreads) spline_lookup_kernel(
    const int32_t* __restrict__ table,      // [n_table]
    const long long* __restrict__ knots,    // [n_knots]
    const double* __restrict__ knot_pos,    // [n_knots]
    const long long* __restrict__ queries,  // [n]
    float* __restrict__ out,                // [n]
    int n, int n_table, int n_knots, int shift, int n_iters, int split) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i >= n) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    const long long q = __ldg(queries + i);

    // 1. radix bucket
    const int n_buckets = n_table - 2;
    int b;
    if (split) {
        b = ((int)(q >> 32)) >> (shift - 32);
    } else {
        b = (int)(unsigned)(unsigned long long)(q >> shift);  // wraps
    }
    b = b < 0 ? 0 : (b > n_buckets - 1 ? n_buckets - 1 : b);

    // 2. the knot segment s, and knots[s .. s + 1], knot_pos[s .. s + 1]
    const int t0 = __ldg(table + b);
    const int t1 = __ldg(table + b + 1);
    int lo = (t0 > 1 ? t0 : 1) - 1;
    int hi = t1 < 0 ? 0 : (t1 > n_knots - 2 ? n_knots - 2 : t1);
    long long k0 = 0, k1 = 0;
    double p0 = 0.0, p1 = 0.0;
    bool found = false;
    for (int left = n_iters;;) {  // the same for every lane
        const int width = hi - lo + 1;
        const int converges = left >= kTreeDepth
            ? 32 : 1 << (left > 0 ? left : 0);
        if (width >= 1 && width <= kRoundKnots && width <= converges) {
            // one round over knots[lo .. hi + 1]; hi + 1 <= K - 1
            long long kv = 0;
            double pv = 0.0;
            if (lane <= width) {
                kv = __ldg(knots + lo + lane);
                pv = __ldg(knot_pos + lo + lane);
            }
            const unsigned le = __ballot_sync(kFull, lane >= 1
                                                     && lane < width
                                                     && kv <= q);
            const unsigned run = le >> 1;  // lanes 1 .. w - 1: bits 0 .. w - 2
            if ((run & (run + 1)) == 0) {  // a run from lane 1: the bisect's end
                const int at = __popc(le);  // s - lo, at most w - 1
                k0 = __shfl_sync(kFull, kv, at);
                k1 = __shfl_sync(kFull, kv, at + 1);
                p0 = __shfl_sync(kFull, pv, at);
                p1 = __shfl_sync(kFull, pv, at + 1);
                found = true;
                break;
            }
        }
        if (left <= 0 || (hi <= lo && lo <= hi + 1)) break;  // lo is final
        // -- bisect round: the next d steps of the reference's bisect
        const int d = left < kTreeDepth ? left : kTreeDepth;
        const int node = lane + 1;  // heap order: node 1 is the next step
        const int depth = 31 - __clz(node);
        // replay the steps that lead to this node: the outcome of step k is
        // bit depth - 1 - k of the node below its leading one
        int a = lo, z = hi;
#pragma unroll
        for (int k = 0; k < kTreeDepth - 1; ++k) {
            const int bit = depth - 1 - k;
            if (bit >= 0) {
                const int mid = (a + z + 1) >> 1;
                const bool up = (node >> bit) & 1;
                a = up ? mid : a;
                z = up ? z : mid - 1;
            }
        }
        const int mid = (a + z + 1) >> 1;
        const int probe = mid < 0 ? 0 : (mid > n_knots - 1 ? n_knots - 1 : mid);
        const bool go = depth < d && __ldg(knots + probe) <= q;
        const int na = go ? mid : a;  // this node's range after its step
        const int nz = go ? z : mid - 1;
        const unsigned g = __ballot_sync(kFull, go);
        // the path's node at depth d - 1 holds the range after step d
        int at = 1;
        for (int k = 1; k < d; ++k) at = 2 * at + ((g >> (at - 1)) & 1u);
        lo = __shfl_sync(kFull, na, at - 1);
        hi = __shfl_sync(kFull, nz, at - 1);
        left -= d;
        // -- end of the bisect round
    }
    if (!found) {  // the same for every lane
        const int s = lo < 0 ? 0 : (lo > n_knots - 2 ? n_knots - 2 : lo);
        k0 = __ldg(knots + s);
        k1 = __ldg(knots + s + 1);
        p0 = __ldg(knot_pos + s);
        p1 = __ldg(knot_pos + s + 1);
    }

    // 3. interpolation
    float dk, seg;
    if (split) {
        dk = split_delta(q, k0);
        seg = split_delta(k1, k0);
    } else {
        dk = __ll2float_rn(q - k0);
        seg = __ll2float_rn(k1 - k0);
    }
    float t = __fdiv_rn(dk, fmaxf(seg, 1.0f));
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float f0 = __double2float_rn(p0);
    const float f1 = __double2float_rn(p1);
    const float d = __fsub_rn(f1, f0);
    if (lane == 0)
        out[i] = split ? __fmaf_rn(t, d, f0) : __fadd_rn(f0, __fmul_rn(t, d));
}

}  // namespace

extern "C" int spline_lookup_launch(
    const void* table, const void* knots, const void* knot_pos,
    const void* queries, void* out, int n, int n_table, int n_knots,
    int shift, int n_iters, int split, void* stream) {
    if (n <= 0) return 0;
    if (n_table < 3 || n_knots < 2) return (int)cudaErrorInvalidValue;
    const int blocks = (n + kWarps - 1) / kWarps;
    spline_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const long long*)knots,
        (const double*)knot_pos, (const long long*)queries, (float*)out,
        n, n_table, n_knots, shift, n_iters, split);
    return (int)cudaGetLastError();
}
