// Shared pieces of the port's CUDA kernels: the activation epilogue and
// the launch-status convention of the C interface.
//
// Every entry point is `extern "C"`, launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() right after the
// launch (0 = launched), so the Python wrapper can raise on a refused
// launch. Built without --use_fast_math: expf/tanhf stay the accurate
// library versions, which keeps silu/gelu within 1e-4 of PyTorch.
#pragma once
#include <cuda_runtime.h>

#include <cmath>

// Activation codes, in the order of repro_torch.kernels._build.ACT_CODES.
enum Act : int {
    ACT_IDENTITY = 0,
    ACT_HARDSWISH = 1,
    ACT_LEAKY_RELU = 2,
    ACT_SILU = 3,
    ACT_RELU = 4,
    ACT_GELU = 5,
};

// The formulas of repro_torch.kernels.ref.ACTIVATIONS, in the same order
// of operations.
__device__ __forceinline__ float apply_act(float x, int act) {
    switch (act) {
    case ACT_HARDSWISH:
        return x * fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) / 6.0f;
    case ACT_LEAKY_RELU:
        return x >= 0.0f ? x : 0.1f * x;
    case ACT_SILU:
        return x * (1.0f / (1.0f + expf(-x)));
    case ACT_RELU:
        return fmaxf(x, 0.0f);
    case ACT_GELU: {
        const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
        const float inner = k0 * (x + 0.044715f * x * x * x);
        return 0.5f * x * (1.0f + tanhf(inner));
    }
    default:
        return x;
    }
}
