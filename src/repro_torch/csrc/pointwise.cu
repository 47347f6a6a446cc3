// Elementwise activation over a flat float32 array.
//
// Replaces the Pallas kernel of src/repro/kernels/pointwise.py
// (`pointwise`, `_pw_kernel`), which pads the flat array to 4096-element
// blocks. Here a grid-stride loop covers any length with no padding, and
// the activations are those of repro_torch.kernels.ref.ACTIVATIONS (the
// Pallas `_act` multiplies hardswish by 1/6 and leaves gelu alone; the
// port follows the reference instead).
//
// Bound on this card: bytes (one read and one write per element). The
// design moves them 16 bytes at a time: the grid (kernels/pointwise.py
// `_plan`) is one thread per float4 up to one wave of blocks on the
// card's SMs, and past that each thread walks the array grid-stride,
// loading two float4s (32 bytes in flight) before it stores either. The
// float4 body needs x and y at the same offset from a 16-byte boundary;
// a scalar head of `head` elements brings both to it, and the elements
// after the last whole float4 form a scalar tail. Where x and y sit at
// different offsets (an offset view of the input into a fresh output),
// the wrapper passes nvec = 0 and every element takes the scalar loop.
// The activation is a template argument, chosen once on the host, so
// apply_act's switch folds away and the loop holds only its formula.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int A>
__device__ __forceinline__ float4 act4(float4 v) {
    return make_float4(apply_act(v.x, A), apply_act(v.y, A),
                       apply_act(v.z, A), apply_act(v.w, A));
}

// x, y: the whole arrays of n elements; [head, head + 4·nvec) is the
// float4 body (16-byte aligned in both), the rest the scalar elements.
template <int A>
__global__ void __launch_bounds__(kThreads)
pointwise_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long n, long long head, long long nvec) {
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    const long long tid =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const float4* x4 = reinterpret_cast<const float4*>(x + head);
    float4* y4 = reinterpret_cast<float4*>(y + head);
    long long i = tid;
    for (; i + step < nvec; i += 2 * step) {
        const float4 a = x4[i];
        const float4 b = x4[i + step];
        y4[i] = act4<A>(a);
        y4[i + step] = act4<A>(b);
    }
    if (i < nvec) y4[i] = act4<A>(x4[i]);
    // scalar elements: k < head is the head, the rest follow the body
    const long long scalars = n - 4 * nvec;
    for (long long k = tid; k < scalars; k += step) {
        const long long e = k < head ? k : k + 4 * nvec;
        y[e] = apply_act(x[e], A);
    }
}

template <int A>
cudaError_t run(const float* x, float* y, long long n, long long head,
                long long nvec, int blocks, cudaStream_t stream) {
    pointwise_kernel<A><<<blocks, kThreads, 0, stream>>>(x, y, n, head,
                                                         nvec);
    return cudaGetLastError();
}

}  // namespace

// `head`, `nvec` and `blocks` come from kernels/pointwise.py `_plan`.
extern "C" int repro_pointwise_f32(const float* x, float* y, long long n,
                                   long long head, long long nvec,
                                   int act, int blocks,
                                   cudaStream_t stream) {
    cudaError_t e;
    switch (act) {
    case ACT_IDENTITY: e = run<ACT_IDENTITY>(x, y, n, head, nvec, blocks,
                                             stream); break;
    case ACT_HARDSWISH: e = run<ACT_HARDSWISH>(x, y, n, head, nvec, blocks,
                                               stream); break;
    case ACT_LEAKY_RELU: e = run<ACT_LEAKY_RELU>(x, y, n, head, nvec,
                                                 blocks, stream); break;
    case ACT_SILU: e = run<ACT_SILU>(x, y, n, head, nvec, blocks, stream);
        break;
    case ACT_RELU: e = run<ACT_RELU>(x, y, n, head, nvec, blocks, stream);
        break;
    case ACT_GELU: e = run<ACT_GELU>(x, y, n, head, nvec, blocks, stream);
        break;
    default: e = cudaErrorInvalidValue;
    }
    return static_cast<int>(e);
}
