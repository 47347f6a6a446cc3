// Shared pieces of the port's CUDA kernels: the activation epilogue, the
// cp.async helpers of the double-buffered and tensor-core kernels, the TF32
// tensor-core instructions of #1, #2 and #7, and the launch-status
// convention of the C interface.
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

// max(a, b) that propagates NaN, as jnp.maximum, torch.max and torch.relu
// do (PTX max.NaN, sm_80+: a NaN operand gives the canonical NaN). Where
// neither operand is NaN it is max.f32, what fmaxf compiles to, bit for
// bit. Not volatile: the compiler may schedule it freely.
__device__ __forceinline__ float max_nan(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

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
        return max_nan(x, 0.0f);
    case ACT_GELU: {
        const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
        const float inner = k0 * (x + 0.044715f * x * x * x);
        return 0.5f * x * (1.0f + tanhf(inner));
    }
    default:
        return x;
    }
}

// cp.async (sm_80+): an asynchronous copy of 4 bytes from global to
// shared memory that bypasses the registers. `src_bytes` 0 reads nothing
// and writes 4 zero bytes: the form every tile edge and every tap outside
// the image takes in the double-buffered kernels, so that a slot never
// keeps the previous stage's data. `gsrc` must be a valid address even
// then (callers pass the operand's base).
__device__ __forceinline__ void cp_async4(void* sdst, const void* gsrc,
                                          bool valid) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(sdst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gsrc), "r"(valid ? 4 : 0));
}

// The same for 16 bytes (cp.async.cg: cached in L2 only); `gsrc` and
// `sdst` 16-byte aligned. `valid` false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* sdst, const void* gsrc,
                                           bool valid) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(sdst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gsrc), "r"(valid ? 16 : 0));
}

// Close the copies issued so far by this thread into one group.
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// tf32(v): v rounded to TF32 (10 mantissa bits, round to nearest, ties
// away from zero), as its f32 bit pattern.
__device__ __forceinline__ unsigned to_tf32(float v) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// d += a·b on the tensor cores: m16n8k8, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
}
