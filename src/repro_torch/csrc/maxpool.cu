// SAME-padded K x K max pool over NHWC, with an optional activation on the
// pooled value.
//
// Replaces the Pallas kernel of src/repro/kernels/maxpool.py (`maxpool2d`,
// `_pool_kernel`), which pads the image with finfo.min into a halo'd strip
// tensor and reduces K^2 shifted slices. Here one thread computes one
// output element straight from the unpadded input: taps outside the image
// count as -FLT_MAX (finfo.min), so the result is bit-equal to padding.
// Neighbouring threads take neighbouring channels, so every tap is a
// coalesced read of a pixel's channel vector.
//
// Bound on this card: bytes (a few compares per element moved). The K^2
// re-reads of a 5x5/s1 window hit L1/L2, not device memory.
#include <cfloat>

#include "common.cuh"

namespace {

__global__ void maxpool_nhwc_kernel(const float* __restrict__ x,
                                    float* __restrict__ y, int N, int H,
                                    int W, int C, int k, int stride, int Ho,
                                    int Wo, int pad_top, int pad_left,
                                    int act, int total) {
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += gridDim.x * blockDim.x) {
        const int c = idx % C;
        int t = idx / C;
        const int ow = t % Wo;
        t /= Wo;
        const int oh = t % Ho;
        const int n = t / Ho;
        const int ih0 = oh * stride - pad_top;
        const int iw0 = ow * stride - pad_left;
        float m = -INFINITY;
        for (int kh = 0; kh < k; ++kh) {
            const int ih = ih0 + kh;
            for (int kw = 0; kw < k; ++kw) {
                const int iw = iw0 + kw;
                const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
                m = fmaxf(m, in ? x[((n * H + ih) * W + iw) * C + c]
                                : -FLT_MAX);
            }
        }
        y[idx] = apply_act(m, act);
    }
}

}  // namespace

extern "C" int repro_maxpool2d_nhwc_f32(
        const float* x, float* y, int N, int H, int W, int C, int k,
        int stride, int Ho, int Wo, int pad_top, int pad_left, int act,
        cudaStream_t stream) {
    const int total = N * Ho * Wo * C;
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    maxpool_nhwc_kernel<<<blocks, threads, 0, stream>>>(
        x, y, N, H, W, C, k, stride, Ho, Wo, pad_top, pad_left, act, total);
    return static_cast<int>(cudaGetLastError());
}
