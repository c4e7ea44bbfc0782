// K7 — window insert: one Movement round of the insert's in-place
// placement, in two launches.
//
// Replaces no TPU kernel: the JAX package runs the round as jnp code
// (src/repro/core/fops.py: insert's grid-segment accept and
// _inplace_window_insert), which XLA compiles into a few fused programs.
// The port ran the same code as about 150 PyTorch launches a round, three
// rounds an insert, and the card idled while the host issued them. This
// kernel pair computes the same round, byte for byte, in two launches.
//
// The round, per pending batch key i (shard-local j and icap from the
// locate; a null sid means shard 0 for every key):
//   * its grid row: clamp(min(j + 1, icap), 0, cap - 1) / W, plus
//     sid * (cap / W) for stacked shards, clamped to the rows of the view;
//   * the accept: each row takes its lowest-indexed pending key, which is
//     the key the reference's stable argsort puts first in the row's
//     segment;
//   * the winner's window (the row's W slots): the insertion point ip (the
//     count of slot keys < k), the nearest empty slots left (l) and right
//     (r) of it, the margin, has_left_occ, r_ok, l_ok and use_right rules,
//     the bounded shift, the placement, then the fill-forward repair
//     (an empty slot's key = the least occupied key at or after it, capped
//     by the window's last key) on every accepted row, placed or not;
//   * per key, in batch order: ok (placed) and failed_span (the key span
//     of an accepted window that could not take its key, else int64 max);
//     when the caller passes them, the count of placed keys and the least
//     failed span are accumulated by atomics, which are exact in any order.
//
// Launch 1 (window_insert_claim_kernel), a thread per key: a pending key
// writes atomicMin(claim[row], i) into an int32 array that the wrapper
// fills with INT32_MAX. Launch 2 (window_insert_apply_kernel), a warp per
// key: a key whose row's claim equals its own index owns the row. Accepted
// rows are distinct, so no warp reads a row that another warp writes.
//
// What bounds it on the H100: neither bytes nor operations. A main-path
// round (4096 padded keys, about 410 pending, W = 64) reads the batch's
// 41 bytes a key and about 410 rows of 17 bytes a slot, and writes the
// rows back: about 1.1 MB, a third of a microsecond at 3.35 TB/s. What is
// left is the two launches and, inside the apply, the chain claim -> row
// load -> warp reductions -> store. The design keeps that chain short:
//   * the lanes hold the row as P = W / 32 consecutive slots each (W below
//     32: one slot on the first W lanes), loaded once;
//   * ip, l, r and has_left_occ are four warp reductions
//     (__reduce_add/max/min_sync, __any_sync) over per-lane partials;
//   * the shift by one slot crosses a lane boundary by one shuffle per
//     array, up or down;
//   * the repair is a per-lane suffix minimum and one five-step warp
//     suffix-min scan across the lanes.
// W may be any power of two up to 256 (P up to 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kMargin = 2;

// the grid row of key i over the whole view of n_rows rows
__device__ __forceinline__ long long grid_row(
    const long long* __restrict__ j, const long long* __restrict__ icap,
    const long long* __restrict__ sid, int i, long long cap, int window,
    long long n_rows) {
    long long s = j[i] + 1;
    const long long c = icap[i];
    s = s < c ? s : c;
    s = s < 0 ? 0 : (s < cap - 1 ? s : cap - 1);
    long long row = s / window;
    if (sid) row += sid[i] * (cap / window);
    row = row < 0 ? 0 : row;
    return row < n_rows - 1 ? row : n_rows - 1;
}

__global__ void __launch_bounds__(kThreads) window_insert_claim_kernel(
    const long long* __restrict__ j, const long long* __restrict__ icap,
    const long long* __restrict__ sid, const bool* __restrict__ pending,
    int* __restrict__ claim, int n, long long cap, int window,
    long long n_rows) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n || !pending[i]) return;
    atomicMin(claim + grid_row(j, icap, sid, i, cap, window, n_rows), i);
}

template <int P>
__global__ void __launch_bounds__(kThreads) window_insert_apply_kernel(
    long long* __restrict__ sk, long long* __restrict__ sv,
    bool* __restrict__ so, const long long* __restrict__ keys,
    const long long* __restrict__ vals, const long long* __restrict__ j,
    const long long* __restrict__ icap, const long long* __restrict__ sid,
    const bool* __restrict__ pending, const int* __restrict__ claim,
    bool* __restrict__ ok_out, long long* __restrict__ span_out,
    unsigned long long* __restrict__ n_placed,
    long long* __restrict__ min_span, int n, long long cap, long long n_rows,
    int window, int movement_k) {
    const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (i >= n) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    long long row = -1;
    if (pending[i]) {
        const long long at = grid_row(j, icap, sid, i, cap, window, n_rows);
        if (claim[at] == i) row = at;
    }
    if (row < 0) {  // not pending, or another key owns the row
        if (lane == 0) {
            ok_out[i] = false;
            span_out[i] = kKeyMax;
        }
        return;
    }

    // the row, P consecutive slots a lane; lanes past a window under 32
    // slots hold occupied KEY_MAX slots, which no rule below reads
    const long long base = row * window;
    const int t0 = lane * P;
    const bool act = t0 < window;
    const long long k = keys[i];
    const long long v = vals[i];
    long long wk[P], wv[P];
    bool wo[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        wk[p] = act ? sk[base + t0 + p] : kKeyMax;
        wv[p] = act ? sv[base + t0 + p] : 0;
        wo[p] = act ? so[base + t0 + p] : true;
    }

    // insertion point, nearest empty slots, an occupied slot left of ip
    int below = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) below += wk[p] < k;
    const int ip = __reduce_add_sync(kFull, below);
    int lc = -1, rc = 2 * window, occ_left = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int t = t0 + p;
        if (!wo[p]) {
            if (t < ip) lc = t;            // the last such t of the lane
            else if (rc > t) rc = t;       // the first such t of the lane
        } else if (t < ip) {
            occ_left = 1;
        }
    }
    const int l = __reduce_max_sync(kFull, lc);
    const int r = __reduce_min_sync(kFull, rc);
    const bool has_left_occ = __any_sync(kFull, occ_left) || row == 0;

    const bool in_bounds = ip >= kMargin && ip <= window - kMargin
                           && has_left_occ;
    const bool r_ok = r < window - 1 && r - ip <= movement_k;
    const bool l_ok = l >= 1 && ip - 1 - l <= movement_k;
    const bool ur = r_ok && (!l_ok || r - ip <= ip - 1 - l);
    const bool can = in_bounds && (ur || l_ok);

    // the bounded shift: right, slot t takes t - 1 over (ip, r]; left,
    // slot t takes t + 1 over [l, ip - 1); then the key goes to its place
    const long long up_k = __shfl_up_sync(kFull, wk[P - 1], 1);
    const long long up_v = __shfl_up_sync(kFull, wv[P - 1], 1);
    const int up_o = __shfl_up_sync(kFull, (int)wo[P - 1], 1);
    const long long dn_k = __shfl_down_sync(kFull, wk[0], 1);
    const long long dn_v = __shfl_down_sync(kFull, wv[0], 1);
    const int dn_o = __shfl_down_sync(kFull, (int)wo[0], 1);
    const int place = ur ? ip : ip - 1;
    long long nk[P], nv[P];
    bool no[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int t = t0 + p;
        long long ck = wk[p], cv = wv[p];
        bool co = wo[p];
        if (can) {
            if (ur && t > ip && t <= r) {
                ck = p == 0 ? up_k : wk[(p + P - 1) % P];
                cv = p == 0 ? up_v : wv[(p + P - 1) % P];
                co = p == 0 ? (bool)up_o : wo[(p + P - 1) % P];
            } else if (!ur && t >= l && t < ip - 1) {
                ck = p == P - 1 ? dn_k : wk[(p + 1) % P];
                cv = p == P - 1 ? dn_v : wv[(p + 1) % P];
                co = p == P - 1 ? (bool)dn_o : wo[(p + 1) % P];
            }
            if (t == place) {
                ck = k;
                cv = v;
                co = true;
            }
        }
        nk[p] = ck;
        nv[p] = cv;
        no[p] = co;
    }

    // fill-forward repair: min(least occupied key at or after t, last key)
    long long suf[P];
    long long run = kKeyMax;
#pragma unroll
    for (int p = P - 1; p >= 0; --p) {
        run = min(run, no[p] ? nk[p] : kKeyMax);
        suf[p] = run;
    }
    long long acc = run;  // becomes the least over this lane and those above
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const long long o = __shfl_down_sync(kFull, acc, off);
        if (lane + off < 32) acc = min(acc, o);
    }
    long long above = __shfl_down_sync(kFull, acc, 1);
    if (lane == 31) above = kKeyMax;
    const int last_lane = (window - 1) / P;  // holds slot W - 1 as p = P - 1
    const long long last = __shfl_sync(kFull, nk[P - 1], last_lane);
    if (act) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
            sk[base + t0 + p] = min(min(suf[p], above), last);
            sv[base + t0 + p] = nv[p];
            so[base + t0 + p] = no[p];
        }
    }

    const long long first_k = __shfl_sync(kFull, wk[0], 0);
    const long long last_k = __shfl_sync(kFull, wk[P - 1], last_lane);
    if (lane == 0) {
        const long long span = (long long)((unsigned long long)last_k
                                           - (unsigned long long)first_k);
        ok_out[i] = can;
        span_out[i] = can ? kKeyMax : span;
        if (n_placed && can) atomicAdd(n_placed, 1ULL);
        if (min_span && !can) atomicMin(min_span, span);
    }
}

template <int P>
void apply(int blocks, cudaStream_t stream, void* sk, void* sv, void* so,
           const void* keys, const void* vals, const void* j,
           const void* icap, const void* sid, const void* pending,
           const void* claim, void* ok, void* span, void* n_placed,
           void* min_span, int n, long long cap, long long n_rows,
           int window, int movement_k) {
    window_insert_apply_kernel<P><<<blocks, kThreads, 0, stream>>>(
        (long long*)sk, (long long*)sv, (bool*)so, (const long long*)keys,
        (const long long*)vals, (const long long*)j, (const long long*)icap,
        (const long long*)sid, (const bool*)pending, (const int*)claim,
        (bool*)ok, (long long*)span, (unsigned long long*)n_placed,
        (long long*)min_span, n, cap, n_rows, window, movement_k);
}

}  // namespace

extern "C" int window_insert_claim_launch(
    const void* j, const void* icap, const void* sid, const void* pending,
    void* claim, int n, long long cap, int window, long long n_rows,
    void* stream) {
    if (n <= 0) return 0;
    if (window < 1 || cap < window || n_rows < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (n + kThreads - 1) / kThreads;
    window_insert_claim_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)j, (const long long*)icap, (const long long*)sid,
        (const bool*)pending, (int*)claim, n, cap, window, n_rows);
    return (int)cudaGetLastError();
}

extern "C" int window_insert_apply_launch(
    void* sk, void* sv, void* so, const void* keys, const void* vals,
    const void* j, const void* icap, const void* sid, const void* pending,
    const void* claim, void* ok, void* span, void* n_placed, void* min_span,
    int n, long long cap, long long n_rows, int window, int movement_k,
    void* stream) {
    if (n <= 0) return 0;
    if (cap < window || n_rows < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (n + kWarps - 1) / kWarps;
    cudaStream_t s = (cudaStream_t)stream;
#define WI_APPLY(P)                                                         \
    apply<P>(blocks, s, sk, sv, so, keys, vals, j, icap, sid, pending,     \
             claim, ok, span, n_placed, min_span, n, cap, n_rows, window,  \
             movement_k)
    if (window <= 32) WI_APPLY(1);
    else if (window == 64) WI_APPLY(2);
    else if (window == 128) WI_APPLY(4);
    else if (window == 256) WI_APPLY(8);
    else return (int)cudaErrorInvalidValue;
#undef WI_APPLY
    return (int)cudaGetLastError();
}
