// Quantized matmuls with the dequantization in the epilogue (paper §IV-A).
//
// Replaces three Pallas kernels of src/repro/kernels/qmatmul.py:
//   * repro_qmatmul_f32         <- `qmatmul` (_qmm_kernel, _unpack4): float
//     activations x integer weight codes (int8, int16, or packed int4),
//     f32 accumulator plus the row sum of x, epilogue
//     acc*scale + xsum*(zero*scale) + b -> act -> + res;
//   * repro_qmatmul_a8          <- `qmatmul_a8` (_qmm_a8_kernel): int8
//     activation codes x int8 / packed-int4 codes, int32 accumulator and
//     row sum, epilogue with the activation scale folded into the weight
//     scale (scale = wscale * x_scale, zero = wzero * scale);
//   * repro_qmatmul_a8_double   <- `qmatmul_a8(pipeline="double")`
//     (_qmm_a8_dma_kernel): #8 with the K slices of x and of the codes
//     double-buffered in shared memory by cp.async (see its section);
//   * repro_qmatmul_a8_grouped  <- `qmatmul_a8` with a per-K-run activation
//     scale (_qmm_a8_grouped_kernel): the int32 sum of each K block of
//     `tk` features is scaled by that block's f32 scale into f32
//     accumulators; epilogue acc*wscale + xsum*(wzero*wscale).
//
// The TPU kernels walk a padded (M, K, N) grid with the K block as the
// sequential grid axis and an accumulator in VMEM scratch. Here one
// 256-thread block owns a 64 x 64 output tile and loops over K itself,
// staging a K slice of x and of the codes in shared memory; every thread
// keeps a 4 x 4 register tile of accumulators and the row sums of its 4
// rows. Bounds are predicated (rows >= M, columns >= N and features >= K
// read as code or value 0), so no padded copy of x, the codes or res is
// made. Packed int4 codes are unpacked while staging: byte r holds
// feature 2r in its low nibble and 2r+1 in its high nibble, sign-extended
// by arithmetic shifts (the last high nibble is padding when K is odd).
// Scale and zero are per tensor (stride 0) or per column (stride 1).
//
// Bound on this card. At the shapes of yolov8n at 640 the float kernel
// does 30-300 FLOPs per byte it must move, above the fp32 ridge
// (67e12 / 3.35e12 = 20), so its bound is operations; this simple tile
// reads shared memory about as often as it does FMAs and runs well below
// the fp32 peak. The int8 kernels are bound by bytes against the int8
// tensor-core peak (1979 TOPS), but run on __dp4a / integer FMAs in the
// CUDA cores, far from that bound. wgmma, int8 mma.sync and TMA are later
// work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 64;         // rows (output pixels) per block
constexpr int BN = 64;         // columns (filters) per block
constexpr int THREADS = 256;

enum CodeKind : int { CODES_INT8 = 0, CODES_INT16 = 1, CODES_PACKED4 = 2 };

// Weight code of logical feature k (< K) and column n.
template <int KIND>
__device__ __forceinline__ int load_code(const void* __restrict__ q, int k,
                                         int n, int N) {
    if (KIND == CODES_INT16)
        return static_cast<const int16_t*>(q)[k * N + n];
    const int8_t* q8 = static_cast<const int8_t*>(q);
    if (KIND == CODES_INT8) return q8[k * N + n];
    const int8_t byte = q8[(k >> 1) * N + n];
    // low nibble: shift left then arithmetic shift right; high: shift right
    return (k & 1) ? (byte >> 4)
                   : (static_cast<int8_t>(static_cast<uint8_t>(byte) << 4)
                      >> 4);
}

// ---------------------------------------------------------------- #7
constexpr int BK_F = 16;

template <int KIND>
__global__ void __launch_bounds__(THREADS)
qmatmul_f32_kernel(const float* __restrict__ x, const void* __restrict__ q,
                   const float* __restrict__ scale, int scale_stride,
                   const float* __restrict__ zero, int zero_stride,
                   const float* __restrict__ b,
                   const float* __restrict__ res, float* __restrict__ y,
                   int M, int K, int N, int act) {
    __shared__ float As[BK_F][BM + 1];
    __shared__ float Bs[BK_F][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;          // column lane of the 4x4 tile
    const int ty = tid / 16;          // row lane of the 4x4 tile
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int ak = tid % BK_F;        // x loader: feature column
    const int bn = n0 + tid % BN;     // code loader: column

    float acc[4][4];
    float xsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        xsum[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }

    for (int k0 = 0; k0 < K; k0 += BK_F) {
        const int k = k0 + ak;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = tid / BK_F + 16 * i;
            const int m = m0 + r;
            As[ak][r] = (m < M && k < K) ? x[m * K + k] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kr = tid / BN + 4 * i;
            const int kb = k0 + kr;
            Bs[kr][tid % BN] = (kb < K && bn < N)
                ? static_cast<float>(load_code<KIND>(q, kb, bn, N)) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK_F; ++kk) {
            float a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                xsum[i] += a[i];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            const float sc = scale[n * scale_stride];
            const float zs = zero[n * zero_stride] * sc;
            float v = acc[i][j] * sc + xsum[i] * zs;
            if (b != nullptr) v += b[n];
            v = apply_act(v, act);
            if (res != nullptr) v += res[m * N + n];
            y[m * N + n] = v;
        }
    }
}

// ---------------------------------------------------------------- #8
// K slice of 32 features, staged as 8 words of 4 int8 codes each, so that
// one __dp4a does four multiply-adds.
constexpr int BK_W = 8;

// One output of #8 and #10: the fold of qmatmul.py:382-383 in its order
// (scale = wscale * x_scale, then zero * scale), bias, act, residual.
__device__ __forceinline__ float a8_output(
        int acc, int xsum, int m, int n, const float* __restrict__ wscale,
        int scale_stride, const float* __restrict__ wzero, int zero_stride,
        float x_scale, const float* __restrict__ b,
        const float* __restrict__ res, int N, int act) {
    const float sc = wscale[n * scale_stride] * x_scale;
    const float zs = wzero[n * zero_stride] * sc;
    float v = static_cast<float>(acc) * sc + static_cast<float>(xsum) * zs;
    if (b != nullptr) v += b[n];
    v = apply_act(v, act);
    if (res != nullptr) v += res[m * N + n];
    return v;
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
qmatmul_a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ q,
                  const float* __restrict__ wscale, int scale_stride,
                  const float* __restrict__ wzero, int zero_stride,
                  float x_scale, const float* __restrict__ b,
                  const float* __restrict__ res, float* __restrict__ y,
                  int M, int K, int N, int act) {
    __shared__ int As[BK_W][BM + 1];
    __shared__ int Bs[BK_W][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int aw = tid % BK_W;        // x loader: word of the slice
    const int bn = n0 + tid % BN;     // code loader: column

    int acc[4][4];
    int xsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        xsum[i] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    }

    for (int k0 = 0; k0 < K; k0 += 4 * BK_W) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = tid / BK_W + 32 * i;
            const int m = m0 + r;
            unsigned word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = k0 + 4 * aw + e;
                const int8_t v = (m < M && k < K) ? xq[m * K + k] : 0;
                word |= static_cast<unsigned>(static_cast<uint8_t>(v))
                        << (8 * e);
            }
            As[aw][r] = static_cast<int>(word);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int w = tid / BN + 4 * i;
            unsigned word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = k0 + 4 * w + e;
                int v = 0;
                if (k < K && bn < N)
                    v = load_code<PACKED ? CODES_PACKED4 : CODES_INT8>(
                        q, k, bn, N);
                word |= static_cast<unsigned>(static_cast<uint8_t>(v))
                        << (8 * e);
            }
            Bs[w][tid % BN] = static_cast<int>(word);
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < BK_W; ++w) {
            int a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[w][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[w][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                xsum[i] = __dp4a(a[i], 0x01010101, xsum[i]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            y[m * N + n] = a8_output(acc[i][j], xsum[i], m, n, wscale,
                                     scale_stride, wzero, zero_stride,
                                     x_scale, b, res, N, act);
        }
    }
}

// ---------------------------------------------------------------- #10
// #8's tile (64 x 64 outputs, 256 threads, a 4 x 4 int32 accumulator and
// the row sums of its 4 rows, __dp4a, the same epilogue) with its K sweep
// double-buffered, as _qmm_a8_dma_kernel walks K inside one (M, N) tile
// on the TPU. Each 32-feature slice of xq (64 rows x 32 bytes) and of the
// codes (32 rows x 64 columns of int8, or 16 byte rows x 64 columns of
// packed int4: a stage boundary falls between byte rows, never inside
// one) lands in shared memory by 4-byte cp.async into stage s & 1, while
// slice s - 1 is contracted. cp.async copies raw bytes and cannot
// transpose, so the code words that #8 packs while staging are built on
// the shared -> register read here: each thread takes 4 consecutive
// columns, reads one word of 4 columns from each of the slice's 4 feature
// rows (2 byte rows when packed, whose nibbles are sign-extended four at
// a time by __vsub4), and transposes the 4 x 4 bytes with __byte_perm.
// Integer sums are exact in any order, so the accumulator equals #8's bit
// for bit; the epilogue is #8's (a8_output).
//
// Operand rules (the wrapper meets them): K % 4 == 0 and the code rows
// `ldq` bytes apart with ldq % 4 == 0, so that every copied word is
// aligned and lies wholly inside or outside the data. The wrapper
// zero-pads K (x columns and code rows, exact: a zero code adds 0 to the
// sum and to the row sum, as the JAX wrapper's _pad_q) and, for N % 4 != 0,
// the code columns. Rows past M, features past K and columns past ldq
// read 0 by src-size 0.
constexpr int BK_D = 32;             // features per slice

__device__ __forceinline__ unsigned nibbles_lo(unsigned p) {
    return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ unsigned nibbles_hi(unsigned p) {
    return __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// Rows r0..r3 hold features f..f+3 of columns c..c+3 (byte j = column
// c+j); col[j] gets features f..f+3 of column c+j (byte e = feature f+e).
__device__ __forceinline__ void transpose4x4(unsigned r0, unsigned r1,
                                             unsigned r2, unsigned r3,
                                             unsigned (&col)[4]) {
    const unsigned t0 = __byte_perm(r0, r1, 0x5140);
    const unsigned t1 = __byte_perm(r0, r1, 0x7362);
    const unsigned u0 = __byte_perm(r2, r3, 0x5140);
    const unsigned u1 = __byte_perm(r2, r3, 0x7362);
    col[0] = __byte_perm(t0, u0, 0x5410);
    col[1] = __byte_perm(t0, u0, 0x7632);
    col[2] = __byte_perm(t1, u1, 0x5410);
    col[3] = __byte_perm(t1, u1, 0x7632);
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
qmatmul_a8_double_kernel(const int8_t* __restrict__ xq,
                         const int8_t* __restrict__ q, int ldq,
                         const float* __restrict__ wscale, int scale_stride,
                         const float* __restrict__ wzero, int zero_stride,
                         float x_scale, const float* __restrict__ b,
                         const float* __restrict__ res,
                         float* __restrict__ y, int M, int K, int N,
                         int act) {
    constexpr int QROWS = PACKED ? BK_D / 2 : BK_D;   // code rows a slice
    __shared__ unsigned Xs[2][BM][BK_D / 4];          // 8 words a row
    __shared__ unsigned Qs[2][QROWS][BN / 4];         // 16 words a row

    const int tid = threadIdx.x;
    const int tx = tid % 16;          // columns 4*tx .. 4*tx+3
    const int ty = tid / 16;          // rows ty + 16*i
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int qcol = n0 + 4 * (tid % 16);     // code loader: first column
    const int qrows = PACKED ? K / 2 : K;     // code rows of the operand

    // Issue the copies of the slice at feature k0 into stage st.
    auto stage = [&](int st, int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {         // 512 words of xq
            const int r = tid / 8 + 32 * i;
            const int m = m0 + r;
            const int k = k0 + 4 * (tid % 8);
            const bool in = m < M && k < K;
            cp_async4(&Xs[st][r][tid % 8], in ? xq + m * K + k : xq, in);
        }
#pragma unroll
        for (int i = 0; i < QROWS / 16; ++i) {  // 256 or 512 code words
            const int r = tid / 16 + 16 * i;
            const int kr = (PACKED ? k0 / 2 : k0) + r;
            const bool in = kr < qrows && qcol < ldq;
            cp_async4(&Qs[st][r][tid % 16], in ? q + kr * ldq + qcol : q,
                      in);
        }
    };

    int acc[4][4];
    int xsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        xsum[i] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    }

    const int n_k = (K + BK_D - 1) / BK_D;
    stage(0, 0);
    cp_async_commit();
    for (int s = 0; s < n_k; ++s) {
        const int st = s & 1;
        if (s + 1 < n_k) stage(st ^ 1, (s + 1) * BK_D);
        cp_async_commit();            // an empty group on the last slice
        cp_async_wait<1>();           // slice s has landed (this thread)
        __syncthreads();              // ... and every thread's copies
#pragma unroll
        for (int w = 0; w < BK_D / 4; ++w) {
            int a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = static_cast<int>(Xs[st][ty + 16 * i][w]);
            unsigned bv[4];
            if constexpr (PACKED) {
                const unsigned p0 = Qs[st][2 * w][tx];
                const unsigned p1 = Qs[st][2 * w + 1][tx];
                transpose4x4(nibbles_lo(p0), nibbles_hi(p0),
                             nibbles_lo(p1), nibbles_hi(p1), bv);
            } else {
                transpose4x4(Qs[st][4 * w][tx], Qs[st][4 * w + 1][tx],
                             Qs[st][4 * w + 2][tx], Qs[st][4 * w + 3][tx],
                             bv);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                xsum[i] = __dp4a(a[i], 0x01010101, xsum[i]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], static_cast<int>(bv[j]),
                                       acc[i][j]);
            }
        }
        __syncthreads();              // stage st is refilled next step
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + 4 * tx + j;
            if (n >= N) continue;
            y[m * N + n] = a8_output(acc[i][j], xsum[i], m, n, wscale,
                                     scale_stride, wzero, zero_stride,
                                     x_scale, b, res, N, act);
        }
    }
}

// ---------------------------------------------------------------- #9
constexpr int BK_G = 32;

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
qmatmul_a8_grouped_kernel(const int8_t* __restrict__ xq,
                          const int8_t* __restrict__ q,
                          const float* __restrict__ sblk, int tk,
                          const float* __restrict__ wscale, int scale_stride,
                          const float* __restrict__ wzero, int zero_stride,
                          const float* __restrict__ b,
                          const float* __restrict__ res,
                          float* __restrict__ y, int M, int K, int N,
                          int act) {
    __shared__ int As[BK_G][BM + 1];
    __shared__ int Bs[BK_G][BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int ak = tid % BK_G;
    const int bn = n0 + tid % BN;

    int acc[4][4];                    // int32 sum within the current block
    int xs[4];
    float facc[4][4];                 // sum over blocks of s_b * block sum
    float fxs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        xs[i] = 0;
        fxs[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            acc[i][j] = 0;
            facc[i][j] = 0.0f;
        }
    }

    int blk = 0;                      // current K block (of tk features)
    int left = tk;                    // features left in it
    for (int k0 = 0; k0 < K; k0 += BK_G) {
        const int k = k0 + ak;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = tid / BK_G + 8 * i;
            const int m = m0 + r;
            As[ak][r] = (m < M && k < K) ? xq[m * K + k] : 0;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int kr = tid / BN + 4 * i;
            const int kb = k0 + kr;
            Bs[kr][tid % BN] = (kb < K && bn < N)
                ? load_code<PACKED ? CODES_PACKED4 : CODES_INT8>(q, kb, bn, N)
                : 0;
        }
        __syncthreads();
        const int kmax = min(BK_G, K - k0);
        for (int kk = 0; kk < kmax; ++kk) {
            int a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                xs[i] += a[i];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
            }
            if (--left == 0) {        // block boundary: same k for all
                const float s = sblk[blk++];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    fxs[i] += s * static_cast<float>(xs[i]);
                    xs[i] = 0;
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        facc[i][j] += s * static_cast<float>(acc[i][j]);
                        acc[i][j] = 0;
                    }
                }
                left = tk;
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            const float sc = wscale[n * scale_stride];
            const float zs = wzero[n * zero_stride] * sc;
            float v = facc[i][j] * sc + fxs[i] * zs;
            if (b != nullptr) v += b[n];
            v = apply_act(v, act);
            if (res != nullptr) v += res[m * N + n];
            y[m * N + n] = v;
        }
    }
}

inline dim3 grid_for(int M, int N) {
    return dim3((M + BM - 1) / BM, (N + BN - 1) / BN);
}

}  // namespace

extern "C" int repro_qmatmul_f32(
        const float* x, const void* q, int code_kind, const float* scale,
        int scale_stride, const float* zero, int zero_stride,
        const float* b, const float* res, float* y, int M, int K, int N,
        int act, cudaStream_t stream) {
    const dim3 grid = grid_for(M, N);
    switch (code_kind) {
    case CODES_INT8:
        qmatmul_f32_kernel<CODES_INT8><<<grid, THREADS, 0, stream>>>(
            x, q, scale, scale_stride, zero, zero_stride, b, res, y, M, K,
            N, act);
        break;
    case CODES_INT16:
        qmatmul_f32_kernel<CODES_INT16><<<grid, THREADS, 0, stream>>>(
            x, q, scale, scale_stride, zero, zero_stride, b, res, y, M, K,
            N, act);
        break;
    case CODES_PACKED4:
        qmatmul_f32_kernel<CODES_PACKED4><<<grid, THREADS, 0, stream>>>(
            x, q, scale, scale_stride, zero, zero_stride, b, res, y, M, K,
            N, act);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qmatmul_a8(
        const int8_t* xq, const int8_t* q, int packed, const float* wscale,
        int scale_stride, const float* wzero, int zero_stride,
        float x_scale, const float* b, const float* res, float* y, int M,
        int K, int N, int act, cudaStream_t stream) {
    const dim3 grid = grid_for(M, N);
    if (packed)
        qmatmul_a8_kernel<true><<<grid, THREADS, 0, stream>>>(
            xq, q, wscale, scale_stride, wzero, zero_stride, x_scale, b,
            res, y, M, K, N, act);
    else
        qmatmul_a8_kernel<false><<<grid, THREADS, 0, stream>>>(
            xq, q, wscale, scale_stride, wzero, zero_stride, x_scale, b,
            res, y, M, K, N, act);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qmatmul_a8_double(
        const int8_t* xq, const int8_t* q, int packed, int ldq,
        const float* wscale, int scale_stride, const float* wzero,
        int zero_stride, float x_scale, const float* b, const float* res,
        float* y, int M, int K, int N, int act, cudaStream_t stream) {
    if (K % 4 != 0 || ldq % 4 != 0 || ldq < N)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = grid_for(M, N);
    if (packed)
        qmatmul_a8_double_kernel<true><<<grid, THREADS, 0, stream>>>(
            xq, q, ldq, wscale, scale_stride, wzero, zero_stride, x_scale,
            b, res, y, M, K, N, act);
    else
        qmatmul_a8_double_kernel<false><<<grid, THREADS, 0, stream>>>(
            xq, q, ldq, wscale, scale_stride, wzero, zero_stride, x_scale,
            b, res, y, M, K, N, act);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qmatmul_a8_grouped(
        const int8_t* xq, const int8_t* q, int packed, const float* sblk,
        int tk, const float* wscale, int scale_stride, const float* wzero,
        int zero_stride, const float* b, const float* res, float* y, int M,
        int K, int N, int act, cudaStream_t stream) {
    if (tk <= 0 || K % tk != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = grid_for(M, N);
    if (packed)
        qmatmul_a8_grouped_kernel<true><<<grid, THREADS, 0, stream>>>(
            xq, q, sblk, tk, wscale, scale_stride, wzero, zero_stride, b,
            res, y, M, K, N, act);
    else
        qmatmul_a8_grouped_kernel<false><<<grid, THREADS, 0, stream>>>(
            xq, q, sblk, tk, wscale, scale_stride, wzero, zero_stride, b,
            res, y, M, K, N, act);
    return static_cast<int>(cudaGetLastError());
}
