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
// Both: rs_iters steps of knot bisect inside the bucket's knot range, IEEE
// division, t clipped to [0, 1], the float64 knot positions rounded to
// float32 in registers (the adapter's astype).
//
// What bounds it on the H100: a chain of dependent random reads (table,
// then knots), i.e. latency, not bandwidth. The design is one thread per
// query in 256-thread blocks with the table and knots read from HBM through
// the read-only path; the ragged edge is masked here, so callers pass
// unpadded batches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_delta.cuh"

namespace {

__global__ void __launch_bounds__(256) spline_lookup_kernel(
    const int32_t* __restrict__ table,      // [n_table]
    const long long* __restrict__ knots,    // [n_knots]
    const double* __restrict__ knot_pos,    // [n_knots]
    const long long* __restrict__ queries,  // [n]
    float* __restrict__ out,                // [n]
    int n, int n_table, int n_knots, int shift, int n_iters, int split) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long q = queries[i];

    // 1. radix bucket
    const int n_buckets = n_table - 2;
    int b;
    if (split) {
        b = ((int)(q >> 32)) >> (shift - 32);
    } else {
        b = (int)(unsigned)(unsigned long long)(q >> shift);  // wraps
    }
    b = b < 0 ? 0 : (b > n_buckets - 1 ? n_buckets - 1 : b);

    // 2. knot bisect
    const int t0 = table[b];
    const int t1 = table[b + 1];
    int lo = (t0 > 1 ? t0 : 1) - 1;
    int hi = t1 < 0 ? 0 : (t1 > n_knots - 2 ? n_knots - 2 : t1);
    for (int it = 0; it < n_iters; ++it) {
        const int mid = (lo + hi + 1) >> 1;
        const bool go = knots[mid] <= q;
        lo = go ? mid : lo;
        hi = go ? hi : mid - 1;
    }
    const int s = lo < 0 ? 0 : (lo > n_knots - 2 ? n_knots - 2 : lo);

    // 3. interpolation
    const long long k0 = knots[s];
    const long long k1 = knots[s + 1];
    const float p0 = __double2float_rn(knot_pos[s]);
    const float p1 = __double2float_rn(knot_pos[s + 1]);
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
    const float d = __fsub_rn(p1, p0);
    out[i] = split ? __fmaf_rn(t, d, p0) : __fadd_rn(p0, __fmul_rn(t, d));
}

}  // namespace

extern "C" int spline_lookup_launch(
    const void* table, const void* knots, const void* knot_pos,
    const void* queries, void* out, int n, int n_table, int n_knots,
    int shift, int n_iters, int split, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    spline_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, (const long long*)knots,
        (const double*)knot_pos, (const long long*)queries, (float*)out,
        n, n_table, n_knots, shift, n_iters, split);
    return (int)cudaGetLastError();
}
