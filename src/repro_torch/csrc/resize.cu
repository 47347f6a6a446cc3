// Integer nearest-neighbour upsample over NHWC:
// out[n, h, w, c] = x[n, h / s, w / s, c].
//
// Replaces the Pallas kernel of src/repro/kernels/resize.py
// (`resize_nearest`, `_resize_kernel`), which reads a strip of input rows
// once and broadcasts it to (th*s, W*s) inside VMEM. Here, likewise, each
// thread reads one input vector once and writes its s^2 copies from
// registers: the input row (n, ih) holds W*C floats in a row, and its
// copies land in output rows ih*s .. ih*s + s-1 at columns iw*s .. iw*s +
// s-1, the same channels. The grid's y walks the N*H input rows, its x
// the vectors of one row; a thread finds its column and channel with one
// division by the vectors per pixel, and nothing else is divided.
//
// The vector is a float4 when C % 4 == 0 and both pointers are 16-byte
// aligned, else one float (kernels/resize.py `_plan` chooses, and sizes
// the grid). Neighbouring threads read neighbouring vectors and write
// neighbouring vectors of each copy, so reads and writes are coalesced.
//
// Indices are int: the wrapper's check_operand refuses an output of 2^31
// or more elements, and the input is no larger than the output.
//
// Bound on this card: bytes (one read, s^2 writes, no arithmetic).
#include "common.cuh"

namespace {

// rows = N*H input rows of W pixels of cv vectors of type T each.
template <typename T>
__global__ void resize_nearest_kernel(const T* __restrict__ x,
                                      T* __restrict__ y, int rows, int W,
                                      int cv, int s) {
    const int row = W * cv;                   // vectors in an input row
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= row) return;
    const int iw = j / cv;
    const int c = j - iw * cv;
    const int out_row = row * s;               // vectors in an output row
    const int col = iw * s * cv + c;           // first copy in its row
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        const T v = x[r * row + j];
        T* out = y + r * s * out_row + col;    // output row r*s
        for (int dy = 0; dy < s; ++dy, out += out_row)
            for (int dx = 0; dx < s; ++dx) out[dx * cv] = v;
    }
}

template <typename T>
cudaError_t run(const void* x, void* y, int rows, int W, int cv, int s,
                int threads, int gx, int gy, cudaStream_t stream) {
    resize_nearest_kernel<T><<<dim3(gx, gy), threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), rows, W, cv, s);
    return cudaGetLastError();
}

}  // namespace

// `vec` (float4 vectors of C/4 a pixel, else floats of C), `threads`,
// `gx` and `gy` come from kernels/resize.py `_plan`.
extern "C" int repro_resize_nearest_nhwc_f32(const float* x, float* y,
                                             int N, int H, int W, int C,
                                             int s, int vec, int threads,
                                             int gx, int gy,
                                             cudaStream_t stream) {
    const cudaError_t e =
        vec ? run<float4>(x, y, N * H, W, C / 4, s, threads, gx, gy, stream)
            : run<float>(x, y, N * H, W, C, s, threads, gx, gy, stream);
    return static_cast<int>(e);
}
