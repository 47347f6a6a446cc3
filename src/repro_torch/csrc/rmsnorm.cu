// Row RMSNorm with the (1 + g) scale:
//     y = x · rsqrt(mean(x²) + eps) · (1 + g)      over the last axis.
//
// Replaces the Pallas kernel of src/repro/kernels/pointwise.py
// (`rmsnorm`, `_rms_kernel`), which normalises tiles of 256 rows and
// pads the row count to a multiple of the tile. Here one block reduces
// one row, so any row count runs with no padding: each thread sums the
// squares of a strided share of the row (16-byte loads when D % 4 == 0
// and every pointer is 16-byte aligned, else one float at a time), the
// block reduces the partial sums in float32 (warp shuffles, then one
// warp over the per-warp sums), and every thread writes its share of
// (x · r) · (1 + g), the reference's order of operations.
//
// Bound on this card: bytes (x read once, y written once; the second
// read of x for the output comes from L1/L2). A row of 4096 floats is
// 16 KB, so a block's two passes stay in cache.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (kThreads >> 5) ? red[lane] : 0.0f;
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    return red[0];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ y, int D, float eps) {
    __shared__ float red[32];
    const long long base = static_cast<long long>(blockIdx.x) * D;
    const float* xr = x + base;
    float* yr = y + base;
    float ss = 0.0f;
    if (kVec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        for (int i = threadIdx.x; i < D / 4; i += kThreads) {
            const float4 v = x4[i];
            ss = fmaf(v.x, v.x, ss);
            ss = fmaf(v.y, v.y, ss);
            ss = fmaf(v.z, v.z, ss);
            ss = fmaf(v.w, v.w, ss);
        }
    } else {
        for (int i = threadIdx.x; i < D; i += kThreads) {
            const float v = xr[i];
            ss = fmaf(v, v, ss);
        }
    }
    const float total = block_sum(ss, red);
    const float r = rsqrtf(total / static_cast<float>(D) + eps);
    if (kVec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* g4 = reinterpret_cast<const float4*>(g);
        float4* y4 = reinterpret_cast<float4*>(yr);
        for (int i = threadIdx.x; i < D / 4; i += kThreads) {
            const float4 v = x4[i];
            const float4 w = g4[i];
            y4[i] = make_float4(v.x * r * (1.0f + w.x), v.y * r * (1.0f + w.y),
                                v.z * r * (1.0f + w.z), v.w * r * (1.0f + w.w));
        }
    } else {
        for (int i = threadIdx.x; i < D; i += kThreads)
            yr[i] = xr[i] * r * (1.0f + g[i]);
    }
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const float* x, const float* g, float* y,
                                 long long rows, int D, float eps, int vec,
                                 cudaStream_t stream) {
    if (rows <= 0) return 0;
    if (rows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(rows));
    if (vec)
        rmsnorm_kernel<true><<<grid, kThreads, 0, stream>>>(x, g, y, D, eps);
    else
        rmsnorm_kernel<false><<<grid, kThreads, 0, stream>>>(x, g, y, D, eps);
    return static_cast<int>(cudaGetLastError());
}
