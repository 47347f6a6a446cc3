// Elementwise activation over a flat float32 array.
//
// Replaces the Pallas kernel of src/repro/kernels/pointwise.py
// (`pointwise`, `_pw_kernel`), which pads the flat array to 4096-element
// blocks. Here a grid-stride loop covers any length with no padding, and
// the activations are those of repro_torch.kernels.ref.ACTIVATIONS (the
// Pallas `_act` multiplies hardswish by 1/6 and leaves gelu alone; the
// port follows the reference instead).
//
// Bound on this card: bytes (one read and one write per element).
#include "common.cuh"

namespace {

__global__ void pointwise_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, long long n,
                                 int act) {
    const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < n; i += step)
        y[i] = apply_act(x[i], act);
}

}  // namespace

extern "C" int repro_pointwise_f32(const float* x, float* y, long long n,
                                   int act, cudaStream_t stream) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
    if (blocks < 1) blocks = 1;
    pointwise_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, y, n, act);
    return static_cast<int>(cudaGetLastError());
}
