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
// repro_conv2d_nhwc_f32_double replaces the other Pallas body of that
// file, `_conv_dma_kernel` (`conv2d(pipeline="double")`), which DMAs halo'd
// row strip i+1 into the second of two VMEM slots while the MXU contracts
// strip i. One strip does not fit twice in an SM's 227 KB (the stem at 640
// needs 131 KB a slot, a 20x20x256 strip 225 KB), and a grid of (image,
// filter tile) would give 8 blocks to 132 SMs, so the double-buffered axis
// here is the reduction loop of #1's output tile: the 16-deep slice of A
// and W for step k+1 is in flight by cp.async (4 bytes each, zero-filled
// where a tap is outside the image or past an edge) while step k is
// contracted. Same grid, tile, slice and (kh, kw, c) reduction order as
// #1, and the same per-thread FMA chain and epilogue (shared below), so
// its output equals #1's bit for bit (chip_smoke.py holds it to 1e-5 and
// reports bit-equality at every conv shape of yolov8n at 640).
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

// The A loader's rows: this thread fills column tid % BK of rows
// tid / BK + 16 * i (i < 4) of every slice; the window of each row.
struct ARows {
    int base[4], ih0[4], iw0[4];
    bool ok[4];

    __device__ ARows(int m0, int tid, int M, int H, int W, int C,
                     int stride, int Ho, int Wo, int pad_top,
                     int pad_left) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + tid / BK + 16 * i;
            ok[i] = m < M;
            const int mm = ok[i] ? m : 0;
            const int n = mm / (Ho * Wo);
            const int r = mm % (Ho * Wo);
            base[i] = n * H * W * C;
            ih0[i] = (r / Wo) * stride - pad_top;
            iw0[i] = (r % Wo) * stride - pad_left;
        }
    }
};

// Reduction index k = (kh * K + kw) * C + c of the HWIO filter.
__device__ __forceinline__ void split_tap(int k, int KKC, int C, int K,
                                          int& kh, int& kw, int& c) {
    c = 0, kh = 0, kw = 0;
    if (k < KKC) {
        c = k % C;
        const int t = k / C;
        kw = t % K;
        kh = t / K;
    }
}

// One staged slice into the 4x4 register tile, in #1's FMA order.
__device__ __forceinline__ void contract_slice(const float (*As)[BM + 1],
                                               const float (*Bs)[BN],
                                               int tx, int ty,
                                               float (&acc)[4][4]) {
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
}

// act(acc + b) + res for the thread's 4x4 outputs.
__device__ __forceinline__ void store_tile(const float (&acc)[4][4],
                                           const float* __restrict__ b,
                                           const float* __restrict__ res,
                                           float* __restrict__ y, int m0,
                                           int f0, int tx, int ty, int M,
                                           int F, int act) {
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

// ---------------------------------------------------------------- #1
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
    const int ak = tid % BK;
    const ARows rows(m0, tid, M, H, W, C, stride, Ho, Wo, pad_top,
                     pad_left);
    // W loader: this thread fills column tid % 64 of rows tid/64 + 4*i.
    const int bf = f0 + tid % BN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < KKC; k0 += BK) {
        const int k = k0 + ak;
        int kh, kw, c;
        split_tap(k, KKC, C, K, kh, kw, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float v = 0.0f;
            const int ih = rows.ih0[i] + kh;
            const int iw = rows.iw0[i] + kw;
            if (rows.ok[i] && k < KKC && ih >= 0 && ih < H && iw >= 0
                && iw < W)
                v = x[rows.base[i] + (ih * W + iw) * C + c];
            As[ak][tid / BK + 16 * i] = v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kr = tid / BN + 4 * i;
            const int kb = k0 + kr;
            Bs[kr][tid % BN] = (kb < KKC && bf < F) ? w[kb * F + bf] : 0.0f;
        }
        __syncthreads();
        contract_slice(As, Bs, tx, ty, acc);
        __syncthreads();
    }
    store_tile(acc, b, res, y, m0, f0, tx, ty, M, F, act);
}

// ---------------------------------------------------------------- #2
// #1 with its shared-memory stage doubled: slice s lands in stage s & 1
// by cp.async; the copies of slice s+1 are issued and committed as one
// group before slice s is contracted, and `cp.async.wait_group 1` then
// leaves only that newest group in flight.
__global__ void __launch_bounds__(THREADS)
conv2d_nhwc_double_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b,
                          const float* __restrict__ res,
                          float* __restrict__ y, int N, int H, int W,
                          int C, int K, int F, int stride, int Ho, int Wo,
                          int pad_top, int pad_left, int act) {
    // 2 x (16 x 65 + 16 x 64) x 4 B = 16,512 B of static shared memory
    __shared__ float As[2][BK][BM + 1];
    __shared__ float Bs[2][BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int M = N * Ho * Wo;
    const int KKC = K * K * C;
    const int m0 = blockIdx.x * BM;
    const int f0 = blockIdx.y * BN;
    const int ak = tid % BK;
    const ARows rows(m0, tid, M, H, W, C, stride, Ho, Wo, pad_top,
                     pad_left);
    const int bf = f0 + tid % BN;

    // Issue the copies of the slice at k0 into stage st. Every element of
    // the stage is written: a tap outside the image, a pixel past M, a
    // filter past F or a k past K*K*C reads 0 (src-size 0).
    auto stage = [&](int st, int k0) {
        const int k = k0 + ak;
        int kh, kw, c;
        split_tap(k, KKC, C, K, kh, kw, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ih = rows.ih0[i] + kh;
            const int iw = rows.iw0[i] + kw;
            const bool in = rows.ok[i] && k < KKC && ih >= 0 && ih < H
                            && iw >= 0 && iw < W;
            cp_async4(&As[st][ak][tid / BK + 16 * i],
                      in ? x + rows.base[i] + (ih * W + iw) * C + c : x, in);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kr = tid / BN + 4 * i;
            const int kb = k0 + kr;
            const bool in = kb < KKC && bf < F;
            cp_async4(&Bs[st][kr][tid % BN], in ? w + kb * F + bf : w, in);
        }
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    const int n_k = (KKC + BK - 1) / BK;
    stage(0, 0);
    cp_async_commit();
    for (int s = 0; s < n_k; ++s) {
        if (s + 1 < n_k) stage((s + 1) & 1, (s + 1) * BK);
        cp_async_commit();            // an empty group on the last slice
        cp_async_wait<1>();           // slice s has landed (this thread)
        __syncthreads();              // ... and every thread's copies
        contract_slice(As[s & 1], Bs[s & 1], tx, ty, acc);
        __syncthreads();              // stage s & 1 is refilled next step
    }
    store_tile(acc, b, res, y, m0, f0, tx, ty, M, F, act);
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

extern "C" int repro_conv2d_nhwc_f32_double(
        const float* x, const float* w, const float* b, const float* res,
        float* y, int N, int H, int W, int C, int K, int F, int stride,
        int Ho, int Wo, int pad_top, int pad_left, int act,
        cudaStream_t stream) {
    const int M = N * Ho * Wo;
    const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
    conv2d_nhwc_double_kernel<<<grid, THREADS, 0, stream>>>(
        x, w, b, res, y, N, H, W, C, K, F, stride, Ho, Wo, pad_top,
        pad_left, act);
    return static_cast<int>(cudaGetLastError());
}
