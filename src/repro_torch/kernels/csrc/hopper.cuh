// Hopper building blocks shared by K6 (ragged_dot.cu) and K6w
// (ragged_dot_wgrad.cu): shared-memory addresses, mbarriers (and a ring
// stage's release by its consumer warps), TMA loads and
// stores (cp.async.bulk.tensor), the wgmma shared-memory descriptor for the
// 128-byte swizzle, wgmma m64n64k16 in bf16 with float32 accumulators, a
// ring's position, a warp's inclusive scan, the persistent grid's size and
// the current device for a launch.
// sm_90a only (wgmma).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ long long warp_incl_scan(long long v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// A position in a ring of N shared-memory stages and the parity of its lap
// (what an mbarrier wait on the stage expects).
template <int N>
struct RingPos {
    int s = 0;
    unsigned phase = 0;
    __device__ __forceinline__ void next() {
        if (++s == N) {
            s = 0;
            phase ^= 1;
        }
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

// After every mbar_init of the CTA, before the barriers are used.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// Consumers free a stage: one arrival per warp once its reads are done.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2)
        : "memory");
}

// A box of shared memory to global memory; the hardware drops the parts
// that fall outside the tensor. Completion is tracked per issuing thread by
// bulk groups (store_commit, store_wait_read, store_wait_all).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
        "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void store_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until none of this thread's committed store groups still reads shared
// memory.
__device__ __forceinline__ void store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void store_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA stores, wgmma operands); before the barrier that hands them over.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier among the first `threads` threads of the CTA (id 1 and up;
// id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1.
// K-major (the reduction contiguous, 128-byte rows of 64 bf16 along it):
// a 16-deep step is +32 bytes, SBO the 1024 bytes between 8-row groups.
// MN-major (rows of the reduction, 128 bytes of 64 M or N values each): a
// step is +16 rows, SBO the 1024 bytes between 8-row groups of the
// reduction, LBO the step to the next 64 values of M or N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// d[64 x 64] += A[64 x 16] x B[16 x 64] (d = A x B where `keep` is 0),
// bf16 in, float32 accumulators in the wgmma fragment layout. TA: A is
// M-major (1) or K-major (0); TB: B is N-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int keep = 1) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n\t}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(keep), "n"(TA), "n"(TB));
}

// For its lifetime, makes the device that holds `ptr` current on this
// thread, with its primary context (where PyTorch allocates); then restores
// the thread's device. A thread whose first CUDA call is one of ours
// (autograd's worker, a pool thread, with every allocation served from
// PyTorch's cache) has no current context, and cuTensorMapEncodeTiled fails
// without one. `err`: the first failure, cudaSuccess if none.
class DeviceOf {
  public:
    explicit DeviceOf(const void* ptr) {
        int dev = -1;
        cudaPointerAttributes a;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaPointerGetAttributes(&a, ptr);
        if (err == cudaSuccess) err = cudaSetDevice(a.device);
        if (err == cudaSuccess && a.device != dev) saved_ = dev;
    }
    ~DeviceOf() {
        if (saved_ >= 0) cudaSetDevice(saved_);
    }
    DeviceOf(const DeviceOf&) = delete;
    DeviceOf& operator=(const DeviceOf&) = delete;

    cudaError_t err;

  private:
    int saved_ = -1;  // the device to restore, -1 for none
};

// CTAs a persistent grid of `kernel` may keep on the card (SMs x CTAs per
// SM at `threads` threads and `smem` bytes of dynamic shared memory), asked
// once per kernel and device (`cache`, 64 entries); a negative CUDA error
// on failure.
template <typename K>
int persistent_ctas(K kernel, int threads, int smem, int* cache) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return -(int)e;
    if (dev >= 0 && dev < 64 && cache[dev] > 0) return cache[dev];
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return -(int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
    const int ctas = sms * per_sm;
    if (dev >= 0 && dev < 64) cache[dev] = ctas;
    return ctas;
}

}  // namespace hopper
