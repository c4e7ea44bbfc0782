// Float32 key deltas as the TPU kernels compute them from (hi, lo)-split
// keys. Shared by K1 (fused_locate.cu) and K5 (spline_lookup.cu), whose
// Pallas originals both interpolate from these deltas.
#pragma once

#include <cuda_runtime.h>

// (a_hi - b_hi) * 2^32 + (a_lo - b_lo), each term rounded to float32 as the
// TPU kernels compute it. The multiply by 2^32 is exact, so the explicit
// round-to-nearest intrinsics only pin what contraction could not change.
__device__ __forceinline__ float split_delta(long long a, long long b) {
    const int ah = (int)(a >> 32), bh = (int)(b >> 32);
    const unsigned al = (unsigned)(a & 0xFFFFFFFFLL);
    const unsigned bl = (unsigned)(b & 0xFFFFFFFFLL);
    const float hi = __int2float_rn(ah - bh);
    const float lo = __fsub_rn(__uint2float_rn(al), __uint2float_rn(bl));
    return __fadd_rn(__fmul_rn(hi, 4294967296.0f), lo);
}
