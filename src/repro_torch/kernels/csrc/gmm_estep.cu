// K3 — GMM E-step: the (N, K) responsibilities of a 1-D Gaussian mixture,
//   logp[i, c] = log w[c] - z * z / 2 - log sd[c],   z = (x[i] - mu[c]) / sd[c]
//   out[i, c]  = exp(logp[i, c] - max_c logp[i, :]) / sum_c exp(...)
// the E-step of the streaming D_update forecaster (Section 3.4).
//
// Replaces the TPU kernel gmm_estep_pallas (src/repro/kernels/gmm_estep.py),
// which tiles the samples in 2048-row blocks with the K parameters resident
// in VMEM. Here one thread owns one sample: the K <= 8 parameters (and their
// logs) sit in shared memory, computed once per block, and the ragged edge
// is masked, so the caller pads nothing.
//
// Arithmetic: full-precision logf/expf and IEEE division, and each multiply,
// add and subtract rounded on its own (__fmul_rn/__fsub_rn/__fadd_rn) in the
// order of the plain torch version (kernels/ref.py), so nvcc cannot contract
// them into fused multiply-adds. No --use_fast_math.
//
// What bounds it on the H100: 4 bytes in and 4K bytes out per sample, a few
// dozen float32 operations; at the forecaster's N <= 8192 the launch itself
// dominates. A simple, correct kernel first.

#include <cuda_runtime.h>
#include <math.h>

#define GMM_MAX_K 8

namespace {

__global__ void __launch_bounds__(256) gmm_estep_kernel(
    const float* __restrict__ x,    // [n]
    const float* __restrict__ w,    // [k]
    const float* __restrict__ mu,   // [k]
    const float* __restrict__ sd,   // [k]
    float* __restrict__ out,        // [n, k], row-major
    int n, int k) {
    __shared__ float s_logw[GMM_MAX_K];
    __shared__ float s_mu[GMM_MAX_K];
    __shared__ float s_sd[GMM_MAX_K];
    __shared__ float s_logsd[GMM_MAX_K];
    if (threadIdx.x < k) {
        const int c = threadIdx.x;
        s_logw[c] = logf(w[c]);
        s_mu[c] = mu[c];
        s_sd[c] = sd[c];
        s_logsd[c] = logf(sd[c]);
    }
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float xi = x[i];
    float lp[GMM_MAX_K];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < GMM_MAX_K; ++c) {
        if (c < k) {
            const float z = __fdiv_rn(__fsub_rn(xi, s_mu[c]), s_sd[c]);
            const float hz = __fmul_rn(0.5f, z);
            const float t = __fsub_rn(s_logw[c], __fmul_rn(hz, z));
            lp[c] = __fsub_rn(t, s_logsd[c]);
            m = fmaxf(m, lp[c]);
        }
    }
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < GMM_MAX_K; ++c) {
        if (c < k) {
            lp[c] = expf(__fsub_rn(lp[c], m));
            sum = __fadd_rn(sum, lp[c]);
        }
    }
    float* row = out + (long long)i * k;
#pragma unroll
    for (int c = 0; c < GMM_MAX_K; ++c) {
        if (c < k) row[c] = __fdiv_rn(lp[c], sum);
    }
}

}  // namespace

extern "C" int gmm_estep_launch(
    const void* x, const void* w, const void* mu, const void* sd, void* out,
    int n, int k, void* stream) {
    if (n <= 0) return 0;
    if (k < 1 || k > GMM_MAX_K) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    gmm_estep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const float*)mu, (const float*)sd,
        (float*)out, n, k);
    return (int)cudaGetLastError();
}
