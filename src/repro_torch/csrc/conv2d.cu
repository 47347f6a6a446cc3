// SAME-padded NHWC convolution with the fused epilogue act(conv + b) + res.
//
// Replaces the Pallas kernel of src/repro/kernels/conv2d.py (`conv2d`,
// grid body `_conv_kernel` / `_conv_strip`), which sweeps halo'd row strips
// of a pre-padded copy of the image through K^2 shifted MXU matmuls.
//
// Here the conv is an implicit GEMM: out (M = N*Ho*Wo pixels, F filters)
// = A (M, K*K*C) x W (K*K*C, F), where A's rows are the pixel windows read
// straight from the unpadded input (taps outside the image read 0, with
// the asymmetric SAME split pad_top = pad_h / 2) and W is the HWIO weight
// tensor as it lies in memory. No strip tensor, no padded copy, no im2col
// buffer. A 256-thread block owns a 64-pixel x 64-filter output tile; each
// step stages a 16-deep slice of A and W in shared memory and every thread
// accumulates a 4x4 register tile with fp32 FMAs (no TF32: the port holds
// the JAX package's float32 results to 1e-4).
//
// Bound on this card: operations. yolov8n's convs do 30-300 FLOPs per byte
// they must move, above the H100's fp32 ridge of 67e12 / 3.35e12 = 20.
// This simple tile reads shared memory about as often as it does FMAs, so
// it runs well below the fp32 peak; wgmma/TMA tiling is later work.
#include "common.cuh"

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // filters per block
constexpr int BK = 16;   // reduction slice staged per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv2d_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b,
                   const float* __restrict__ res, float* __restrict__ y,
                   int N, int H, int W, int C, int K, int F, int stride,
                   int Ho, int Wo, int pad_top, int pad_left, int act) {
    __shared__ float As[BK][BM + 1];
    __shared__ float Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;          // filter lane of the 4x4 tile
    const int ty = tid / 16;          // pixel lane of the 4x4 tile
    const int M = N * Ho * Wo;
    const int KKC = K * K * C;
    const int m0 = blockIdx.x * BM;
    const int f0 = blockIdx.y * BN;

    // A loader: this thread fills column ak of rows tid/16 + 16*i.
    const int ak = tid % BK;
    int a_base[4], a_ih0[4], a_iw0[4];
    bool a_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + tid / BK + 16 * i;
        a_ok[i] = m < M;
        const int mm = a_ok[i] ? m : 0;
        const int n = mm / (Ho * Wo);
        const int r = mm % (Ho * Wo);
        a_base[i] = n * H * W * C;
        a_ih0[i] = (r / Wo) * stride - pad_top;
        a_iw0[i] = (r % Wo) * stride - pad_left;
    }
    // W loader: this thread fills column tid % 64 of rows tid/64 + 4*i.
    const int bf = f0 + tid % BN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < KKC; k0 += BK) {
        const int k = k0 + ak;
        int c = 0, kh = 0, kw = 0;
        if (k < KKC) {
            c = k % C;
            const int t = k / C;
            kw = t % K;
            kh = t / K;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float v = 0.0f;
            const int ih = a_ih0[i] + kh;
            const int iw = a_iw0[i] + kw;
            if (a_ok[i] && k < KKC && ih >= 0 && ih < H && iw >= 0 && iw < W)
                v = x[a_base[i] + (ih * W + iw) * C + c];
            As[ak][tid / BK + 16 * i] = v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kr = tid / BN + 4 * i;
            const int kb = k0 + kr;
            Bs[kr][tid % BN] = (kb < KKC && bf < F) ? w[kb * F + bf] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int f = f0 + tx + 16 * j;
            if (f >= F) continue;
            float v = apply_act(acc[i][j] + b[f], act);
            if (res != nullptr) v += res[m * F + f];
            y[m * F + f] = v;
        }
    }
}

}  // namespace

extern "C" int repro_conv2d_nhwc_f32(
        const float* x, const float* w, const float* b, const float* res,
        float* y, int N, int H, int W, int C, int K, int F, int stride,
        int Ho, int Wo, int pad_top, int pad_left, int act,
        cudaStream_t stream) {
    const int M = N * Ho * Wo;
    const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
    conv2d_nhwc_kernel<<<grid, THREADS, 0, stream>>>(
        x, w, b, res, y, N, H, W, C, K, F, stride, Ho, Wo, pad_top,
        pad_left, act);
    return static_cast<int>(cudaGetLastError());
}
