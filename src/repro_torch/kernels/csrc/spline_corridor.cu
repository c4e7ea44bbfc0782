// K8 — spline corridor: the knot indices of the radix spline's greedy
// corridor (GreedySplineCorridor), in two launches.
//
// Replaces no TPU kernel: both packages build the spline on the host, in
// the loop of _greedy_spline_knots (src/repro/core/radix_spline.py, and
// its copy in src/repro_torch/core/radix_spline.py). That loop walks the
// knots one at a time: from anchor i it takes the next window (8192)
// points' slopes and corridor bounds in NumPy and places the next knot
// just before the first point whose slope leaves the corridor. At 16M
// keys it is about 90,000 sequential steps of 8191-point NumPy arithmetic,
// most of the bulk load's time. This kernel pair gives the same knots, bit
// for bit.
//
// The loop body depends only on its anchor i, so the next knot nxt(i) is
// computed for every anchor at once, and the knots are the chain
// 0 -> nxt(0) -> nxt(nxt(0)) ... walked afterwards.
//
// Launch 1 (spline_corridor_next_kernel), a thread per anchor i < n - 1.
// It scans m = i + 1 .. min(n, i + window) - 1 with the loop's float64
// arithmetic, one IEEE operation at a time (__dsub_rn/__dadd_rn/__ddiv_rn,
// so nothing is contracted; no --use_fast_math):
//   kf = (double)key, pf = (double)position      (round to nearest, as
//                                                   NumPy's astype)
//   dx = kf[m] - kf[i]
//   slope = (pf[m] - pf[i]) / dx
//   hi = ((pf[m] + E) - pf[i]) / dx,  lo = ((pf[m] - E) - pf[i]) / dx
// Keys above 2^53 round, so dx can be 0 and the quotients inf or NaN. The
// thread keeps hi_min and lo_max over the points before m, from +-inf,
// propagating NaN as np.minimum / np.maximum do (fmin and fmax drop it),
// and stops at the first m where !(slope <= hi_min && slope >= lo_max):
// nxt[i] = m - 1, or min(n, i + window) - 1 where no point fails, and
// i + 1 where that is i (the loop's progress guard).
//
// Launch 2 (spline_corridor_chain_kernel), one block: it follows nxt from
// 0 while i < n - 1, writing each knot, then the count (adding n - 1 if
// the chain did not end there, as the loop does).
//
// What bounds it on the H100: float64 division. A scanned point costs
// three correctly rounded divisions (a reciprocal seed and a few DFMAs
// each) against 16 bytes of keys and positions, which neighbouring lanes
// share: lane l of a warp takes anchor i0 + l, so at step t the warp reads
// 32 consecutive keys, through L1 (__ldg), and most of a lane's reads hit
// lines its neighbours brought in. At the 16M-key cell (corridors of about
// 170 points) that is about 8e9 divisions, a few milliseconds of the
// card's FP64 rate; the arrays are 256 MB in and 64 MB out, about 0.1 ms
// at 3.35 TB/s. A lane stops at its own corridor's end, and its warp runs
// until its longest lane stops.
//
// The chain is about 90,000 dependent reads. A read of nxt from device
// memory is about a microsecond, so the block stages nxt[i .. i + 8192)
// in shared memory with all its threads, and one thread follows the chain
// through it until it leaves the tile; a tile holds about 48 knots of the
// cell, so the walk waits on device memory once for every 48 reads.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChainThreads = 256;
constexpr int kTile = 8192;  // nxt entries staged at a time (32 KB)

// np.minimum / np.maximum: a NaN in either operand gives NaN
__device__ __forceinline__ double nan_min(double a, double b) {
    return (b < a || b != b) ? b : a;
}

__device__ __forceinline__ double nan_max(double a, double b) {
    return (b > a || b != b) ? b : a;
}

__global__ void __launch_bounds__(kThreads) spline_corridor_next_kernel(
    const long long* __restrict__ keys,  // [n], sorted
    const long long* __restrict__ pos,   // [n]
    int* __restrict__ nxt,               // [n - 1]
    int n, double e, int window) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n - 1) return;
    const double ki = __ll2double_rn(__ldg(keys + i));
    const double pi = __ll2double_rn(__ldg(pos + i));
    const int end = (int)min((long long)n, (long long)i + window);
    double hi_min = CUDART_INF;
    double lo_max = -CUDART_INF;
    int m = i + 1;
    for (; m < end; ++m) {
        const double km = __ll2double_rn(__ldg(keys + m));
        const double pm = __ll2double_rn(__ldg(pos + m));
        const double dx = __dsub_rn(km, ki);
        const double slope = __ddiv_rn(__dsub_rn(pm, pi), dx);
        if (!(slope <= hi_min && slope >= lo_max)) break;
        hi_min = nan_min(hi_min,
                         __ddiv_rn(__dsub_rn(__dadd_rn(pm, e), pi), dx));
        lo_max = nan_max(lo_max,
                         __ddiv_rn(__dsub_rn(__dsub_rn(pm, e), pi), dx));
    }
    // m is the first point outside the corridor, or end
    nxt[i] = m - 1 == i ? i + 1 : m - 1;
}

__global__ void __launch_bounds__(kChainThreads) spline_corridor_chain_kernel(
    const int* __restrict__ nxt,  // [n - 1]
    int* __restrict__ knots,      // [n]
    int* __restrict__ count,      // [1]
    int n) {
    __shared__ int tile[kTile];
    __shared__ int s_cur, s_count;
    if (threadIdx.x == 0) {
        knots[0] = 0;
        s_cur = 0;
        s_count = 1;
    }
    __syncthreads();
    for (;;) {
        const int base = s_cur;
        if (base >= n - 1) break;  // the same for every thread
        const int len = min(kTile, n - 1 - base);
        for (int t = threadIdx.x; t < len; t += kChainThreads)
            tile[t] = nxt[base + t];
        __syncthreads();
        if (threadIdx.x == 0) {
            int cur = base, c = s_count;
            while (cur < n - 1 && cur - base < len) {
                cur = tile[cur - base];
                knots[c++] = cur;
            }
            s_cur = cur;
            s_count = c;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        int c = s_count;
        if (s_cur != n - 1) knots[c++] = n - 1;
        *count = c;
    }
}

}  // namespace

extern "C" int spline_corridor_launch(
    const void* keys, const void* pos, void* nxt, void* knots, void* count,
    int n, int max_error, int window, void* stream) {
    if (n < 2 || window < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (int)((n - 1 + (long long)kThreads - 1) / kThreads);
    spline_corridor_next_kernel<<<blocks, kThreads, 0, s>>>(
        (const long long*)keys, (const long long*)pos, (int*)nxt, n,
        (double)max_error, window);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    spline_corridor_chain_kernel<<<1, kChainThreads, 0, s>>>(
        (const int*)nxt, (int*)knots, (int*)count, n);
    return (int)cudaGetLastError();
}
