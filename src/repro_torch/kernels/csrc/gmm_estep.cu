// K3 — GMM E-step: the (N, K) responsibilities of a 1-D Gaussian mixture,
//   logp[i, c] = log w[c] - z * z / 2 - log sd[c],   z = (x[i] - mu[c]) / sd[c]
//   out[i, c]  = exp(logp[i, c] - max_c logp[i, :]) / sum_c exp(...)
// the E-step of the streaming D_update forecaster (Section 3.4).
//
// Replaces the TPU kernel gmm_estep_pallas (src/repro/kernels/gmm_estep.py),
// which tiles the samples in 2048-row blocks with the K parameters resident
// in VMEM. Here the ragged edge is masked, so the caller pads nothing.
//
// Arithmetic: full-precision logf/expf and IEEE division, and each multiply,
// add and subtract rounded on its own (__fmul_rn/__fsub_rn/__fadd_rn) in the
// order of the plain torch version (kernels/ref.py), so nvcc cannot contract
// them into fused multiply-adds. No --use_fast_math. The max is exact in any
// order, and the sum adds the K exponentials in the order c = 0 .. K - 1,
// so every rounding is the one-thread-per-sample design's, and the output
// is bit-identical to it.
//
// What bounds it on the H100: 4 bytes in and 4K bytes out per sample and a
// few dozen float32 operations, so at the forecaster's N <= 8192 neither
// bytes nor operations but the launch, and inside it each thread's serial
// work. The first design gave a thread one sample: after a __syncthreads
// on each CTA's logf of the parameters, it ran K IEEE divisions, K expf and
// K more divisions one after another, on 8 CTAs for 2048 samples. This
// design gives a sample a group of P = next_pow2(K) lanes:
//   * lane c of the group owns component c: it loads w[c], mu[c], sd[c]
//     and takes their logf itself (no shared memory, no barrier), then one
//     division, one expf and one division of its own;
//   * the max is a __shfl_xor_sync butterfly over the group; the sum
//     gathers the K exponentials by __shfl_sync and adds them in order;
//   * lanes c >= K (K not a power of two) hold -inf and write nothing;
//   * each lane writes out[i * K + c], so a warp's stores are one
//     contiguous run; 128-thread CTAs, so 2048 samples with K = 4 run on 64
//     CTAs.
// Groups of 1 to 32 lanes serve K <= 32. Above that a warp takes a sample
// (gmm_estep_wide_kernel) and lane l owns components l, l + 32, ...: the
// max runs over its own components, then over the warp; the sum gathers
// the exponentials by __shfl_sync 32 components at a time, in the order
// c = 0 .. K - 1; each pass takes the logs again rather than hold a
// register array sized to K, so no compile-time bound on K is left. The
// passes repeat the same operations on the same inputs, so they round
// alike, and every K rounds as the one-thread-per-sample loop does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 32;  // widest lane group; a warp per sample above
constexpr unsigned kFull = 0xFFFFFFFFu;

// log w[c] - z * z / 2 - log sd[c], z = (xi - mu[c]) / sd[c], each
// operation rounded on its own
__device__ __forceinline__ float log_density(
    float xi, const float* __restrict__ w, const float* __restrict__ mu,
    const float* __restrict__ sd, int c) {
    const float s = __ldg(sd + c);
    const float z = __fdiv_rn(__fsub_rn(xi, __ldg(mu + c)), s);
    const float hz = __fmul_rn(0.5f, z);
    const float v = __fsub_rn(logf(__ldg(w + c)), __fmul_rn(hz, z));
    return __fsub_rn(v, logf(s));
}

template <int P>
__global__ void __launch_bounds__(kThreads) gmm_estep_kernel(
    const float* __restrict__ x,    // [n]
    const float* __restrict__ w,    // [k]
    const float* __restrict__ mu,   // [k]
    const float* __restrict__ sd,   // [k]
    float* __restrict__ out,        // [n, k], row-major
    int n, int k) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    if ((t & ~31LL) / P >= n) return;  // the whole warp is past the end
    const int c = threadIdx.x & (P - 1);  // the component this lane owns
    const long long i = t / P;
    const bool own = i < n && c < k;

    const float lp = own ? log_density(__ldg(x + i), w, mu, sd, c)
                         : -INFINITY;
    // fmaxf drops a NaN, as the serial max from -inf did
    float m = fmaxf(-INFINITY, lp);
#pragma unroll
    for (int o = 1; o < P; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, o, P));
    const float e = own ? expf(__fsub_rn(lp, m)) : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int cc = 0; cc < P; ++cc) {
        const float ec = __shfl_sync(kFull, e, cc, P);
        if (cc < k) sum = __fadd_rn(sum, ec);
    }
    if (own) out[i * k + c] = __fdiv_rn(e, sum);
}

// K > 32: a warp per sample, lane l owning components l, l + 32, ...
__global__ void __launch_bounds__(kThreads) gmm_estep_wide_kernel(
    const float* __restrict__ x,    // [n]
    const float* __restrict__ w,    // [k]
    const float* __restrict__ mu,   // [k]
    const float* __restrict__ sd,   // [k]
    float* __restrict__ out,        // [n, k], row-major
    int n, int k) {
    const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (i >= n) return;  // the same for every lane of the warp
    const int lane = threadIdx.x & 31;
    const float xi = __ldg(x + i);
    float m = -INFINITY;  // fmaxf drops a NaN, as the serial max did
    for (int c = lane; c < k; c += 32)
        m = fmaxf(m, log_density(xi, w, mu, sd, c));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float sum = 0.0f;
    for (int base = 0; base < k; base += 32) {  // the same for every lane
        const int c = base + lane;
        const float e = c < k
            ? expf(__fsub_rn(log_density(xi, w, mu, sd, c), m)) : 0.0f;
        const int nc = k - base < 32 ? k - base : 32;
        for (int cc = 0; cc < nc; ++cc)
            sum = __fadd_rn(sum, __shfl_sync(kFull, e, cc));
    }
    for (int c = lane; c < k; c += 32)
        out[i * k + c] = __fdiv_rn(
            expf(__fsub_rn(log_density(xi, w, mu, sd, c), m)), sum);
}

template <int P>
void launch(const float* x, const float* w, const float* mu, const float* sd,
            float* out, int n, int k, cudaStream_t stream) {
    const long long per_block = kThreads / P;
    const int blocks = (int)((n + per_block - 1) / per_block);
    gmm_estep_kernel<P><<<blocks, kThreads, 0, stream>>>(x, w, mu, sd, out,
                                                         n, k);
}

}  // namespace

extern "C" int gmm_estep_launch(
    const void* x, const void* w, const void* mu, const void* sd, void* out,
    int n, int k, void* stream) {
    if (n <= 0) return 0;
    if (k < 1) return (int)cudaErrorInvalidValue;
    const float* xs = (const float*)x;
    const float* ws = (const float*)w;
    const float* ms = (const float*)mu;
    const float* ss = (const float*)sd;
    float* o = (float*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (k == 1) launch<1>(xs, ws, ms, ss, o, n, k, st);
    else if (k == 2) launch<2>(xs, ws, ms, ss, o, n, k, st);
    else if (k <= 4) launch<4>(xs, ws, ms, ss, o, n, k, st);
    else if (k <= 8) launch<8>(xs, ws, ms, ss, o, n, k, st);
    else if (k <= 16) launch<16>(xs, ws, ms, ss, o, n, k, st);
    else if (k <= kMaxGroup) launch<kMaxGroup>(xs, ws, ms, ss, o, n, k, st);
    else gmm_estep_wide_kernel<<<(int)((n + kWarps - 1LL) / kWarps),
                                 kThreads, 0, st>>>(xs, ws, ms, ss, o, n, k);
    return (int)cudaGetLastError();
}
