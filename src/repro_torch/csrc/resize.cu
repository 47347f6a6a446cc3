// Integer nearest-neighbour upsample over NHWC:
// out[n, h, w, c] = x[n, h / s, w / s, c].
//
// Replaces the Pallas kernel of src/repro/kernels/resize.py
// (`resize_nearest`, `_resize_kernel`), which broadcasts each row strip
// to (th*s, W*s) inside VMEM. Here one thread writes one output element;
// neighbouring threads write neighbouring channels, so reads and writes
// are coalesced and each input element is fetched s^2 times from L1/L2.
//
// Bound on this card: bytes (one read, s^2 writes, no arithmetic).
#include "common.cuh"

namespace {

__global__ void resize_nearest_nhwc_kernel(const float* __restrict__ x,
                                           float* __restrict__ y, int H,
                                           int W, int C, int s, int total) {
    const int Wo = W * s;
    const int Ho = H * s;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += gridDim.x * blockDim.x) {
        const int c = idx % C;
        int t = idx / C;
        const int ow = t % Wo;
        t /= Wo;
        const int oh = t % Ho;
        const int n = t / Ho;
        y[idx] = x[((n * H + oh / s) * W + ow / s) * C + c];
    }
}

}  // namespace

extern "C" int repro_resize_nearest_nhwc_f32(const float* x, float* y,
                                             int N, int H, int W, int C,
                                             int s, cudaStream_t stream) {
    const int total = N * H * s * W * s * C;
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    resize_nearest_nhwc_kernel<<<blocks, threads, 0, stream>>>(
        x, y, H, W, C, s, total);
    return static_cast<int>(cudaGetLastError());
}
