// Mamba-2 SSD (state-space duality) chunked scan, float32 throughout:
// y (Bt, T, H, P) and the final state (Bt, H, N, P) from x (Bt, T, H, P),
// dt (Bt, T, H), A (H,), B and C (Bt, T, G, N) per group, and an optional
// initial state h0 (Bt, H, N, P).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py (`ssd_scan`,
// `_ssd_kernel`), and covers everything nn/ssm.py:ssd_chunked computes
// (it also takes h0, where the Pallas kernel starts from zero). The
// Pallas grid (batch, head tile, chunk) runs the chunk axis in order on
// one core and carries the (heads, N, P) state in VMEM scratch from one
// grid step to the next. Blocks on this card run in no order, so the
// chunk sweep is a loop inside the block: one block per (batch, head,
// 16-column tile of P) walks every chunk of the sequence with its
// N x 16 slice of the state in shared memory. State columns are
// independent (y[t, h, p] reads only S[h, :, p]), so splitting P gives a
// one-request prefill more blocks than heads (96 for mamba2-130m, 256 for
// zamba2-1.2b).
//
// Per chunk of TC = 64 tokens (the kernel's own tile; any chunk is the
// same math), with cs the inclusive cumulative sum of dt·A in the chunk:
//   W[t][s] = (C_t · B_s) · exp(cs_t − cs_s) · dt_s  for s <= t, else 0
//   y_t     = Σ_s W[t][s] x_s + exp(cs_t) · (C_t · S)
//   S      <- exp(cs_last) · S + Σ_s exp(cs_last − cs_s) · dt_s · B_s ⊗ x_s
// * The exponent is never taken where s > t (it is positive there and
//   would overflow), as the JAX code masks it before exp.
// * Head h reads group h / (H / G) of B and C by index; the `repeat` of
//   the JAX code is never made.
// * A ragged last chunk, and T below one chunk, stage zeros past T with
//   dt = 0: decay 1 and no input, so y and S are unchanged by them.
//
// Thread layout: 256 threads as 16 x 16 (ty, tx). W: rows ty + 16·i,
// columns tx + 16·j (i, j < 4), dot products over N from float4 reads of
// rows padded to N + 4 floats. y: rows ty + 16·i, state column tx. S:
// rows n ≡ ty (mod 16), column tx; a thread updates exactly the state
// entries it owns.
//
// Bound on this card: operations (the chunked algorithm's C·Bᵀ, W·x, C·S
// and state update over the 67 TFLOP/s fp32 peak; no tensor cores, no
// TF32, no fast math). This simple kernel recomputes C·Bᵀ in every block
// of a group, 62% of its FMAs at N = 128. Shared memory:
// 2·64·(N+4) + 64·PT + 64·68 + N·PT + 256 floats with PT = 16 (98 KB at
// N = 128, the most it takes), above the 48 KB default, so the launch
// opts in with cudaFuncSetAttribute.
#include "common.cuh"

namespace {

constexpr int TC = 64;
constexpr int PT = 16;              // columns of P a block owns
constexpr int WS = TC + 4;          // padded row stride of W
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

constexpr int smem_floats(int N) {
    return 2 * TC * (N + 4) + TC * PT + TC * WS + N * PT + 4 * TC;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ s_out, int T,
                int H, int G, int N, int P) {
    const int NS = N + 4;               // padded row stride of B and C
    extern __shared__ float4 smem4[];
    float* sB = reinterpret_cast<float*>(smem4);
    float* sC = sB + TC * NS;
    float* sX = sC + TC * NS;
    float* sW = sX + TC * PT;
    float* sS = sW + TC * WS;
    float* sCs = sS + N * PT;           // cs_t
    float* sDt = sCs + TC;              // dt_t
    float* sEcs = sDt + TC;             // exp(cs_t)
    float* sWs = sEcs + TC;             // exp(cs_last − cs_s) · dt_s

    const int n_pt = P / PT;
    const int pt = blockIdx.x % n_pt;
    const int h = (blockIdx.x / n_pt) % H;
    const int b = blockIdx.x / (n_pt * H);
    const int g = h / (H / G);
    const int p0 = pt * PT;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float a = A[h];
    const long long row0 = static_cast<long long>(b) * T;   // (b, t = 0)

    for (int n = ty; n < N; n += 16)
        sS[n * PT + tx] =
            h0 ? h0[((static_cast<long long>(b) * H + h) * N + n) * P + p0
                    + tx]
               : 0.0f;

    for (int t0 = 0; t0 < T; t0 += TC) {
        const int L = min(TC, T - t0);
        __syncthreads();                // last chunk's reads done; S ready
        const int VB = N / 4;
        for (int f = threadIdx.x; f < TC * VB; f += kThreads) {
            const int r = f / VB, c = f % VB;
            float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
            if (r < L) {
                const long long off = ((row0 + t0 + r) * G + g) * N;
                bv = reinterpret_cast<const float4*>(B + off)[c];
                cv = reinterpret_cast<const float4*>(C + off)[c];
            }
            reinterpret_cast<float4*>(sB + r * NS)[c] = bv;
            reinterpret_cast<float4*>(sC + r * NS)[c] = cv;
        }
        constexpr int VX = PT / 4;
        for (int f = threadIdx.x; f < TC * VX; f += kThreads) {
            const int r = f / VX, c = f % VX;
            float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < L)
                xv = reinterpret_cast<const float4*>(
                    x + ((row0 + t0 + r) * H + h) * P + p0)[c];
            reinterpret_cast<float4*>(sX + r * PT)[c] = xv;
        }
        if (threadIdx.x < 32) {         // two tokens per lane: cumsum of dt·A
            const int lane = threadIdx.x, r0 = 2 * lane, r1 = r0 + 1;
            const float d0 = r0 < L ? dt[(row0 + t0 + r0) * H + h] : 0.0f;
            const float d1 = r1 < L ? dt[(row0 + t0 + r1) * H + h] : 0.0f;
            const float v0 = d0 * a, v1 = d1 * a;
            float incl = v0 + v1;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float u = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += u;
            }
            float excl = __shfl_up_sync(0xffffffffu, incl, 1);
            if (lane == 0) excl = 0.0f;
            const float c0 = excl + v0, c1 = c0 + v1;
            const float last = __shfl_sync(0xffffffffu, c1, 31);
            sCs[r0] = c0;
            sCs[r1] = c1;
            sDt[r0] = d0;
            sDt[r1] = d1;
            sEcs[r0] = expf(c0);
            sEcs[r1] = expf(c1);
            sWs[r0] = expf(last - c0) * d0;
            sWs[r1] = expf(last - c1) * d1;
        }
        __syncthreads();

        // W = (C Bᵀ) ⊙ exp(cs_t − cs_s) · dt_s on s <= t
        {
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
            for (int n = 0; n < N; n += 4) {
                float4 cv[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    cv[i] = *reinterpret_cast<const float4*>(
                        sC + (ty + 16 * i) * NS + n);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    bv[j] = *reinterpret_cast<const float4*>(
                        sB + (tx + 16 * j) * NS + n);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int t = ty + 16 * i, s = tx + 16 * j;
                    sW[t * WS + s] = s <= t
                        ? acc[i][j] * expf(sCs[t] - sCs[s]) * sDt[s]
                        : 0.0f;
                }
        }
        __syncthreads();

        // y = W·x + exp(cs) ⊙ (C·S)
        {
            float yi[4], ys[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) yi[i] = ys[i] = 0.0f;
#pragma unroll 2
            for (int s = 0; s < TC; s += 4) {
                float4 wv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    wv[i] = *reinterpret_cast<const float4*>(
                        sW + (ty + 16 * i) * WS + s);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float xv = sX[(s + c) * PT + tx];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        yi[i] = fmaf(comp(wv[i], c), xv, yi[i]);
                }
            }
#pragma unroll 2
            for (int n = 0; n < N; n += 4) {
                float4 cv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    cv[i] = *reinterpret_cast<const float4*>(
                        sC + (ty + 16 * i) * NS + n);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float sv = sS[(n + c) * PT + tx];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        ys[i] = fmaf(comp(cv[i], c), sv, ys[i]);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = ty + 16 * i;
                if (t >= L) continue;
                y[((row0 + t0 + t) * H + h) * P + p0 + tx] =
                    fmaf(sEcs[t], ys[i], yi[i]);
            }
        }
        __syncthreads();                // every read of S done

        // S <- exp(cs_last)·S + Σ_s (B_s · w_s) ⊗ x_s, four rows at a time
        {
            const float e_last = sEcs[TC - 1];   // cs is flat past L
            for (int n0 = ty; n0 < N; n0 += 64) {
                float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
                for (int s = 0; s < TC; ++s) {
                    const float w = sWs[s], xv = sX[s * PT + tx];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (n0 + 16 * i < N)
                            acc[i] = fmaf(sB[s * NS + n0 + 16 * i] * w, xv,
                                          acc[i]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int n = n0 + 16 * i;
                    if (n >= N) continue;
                    float* sp = sS + n * PT + tx;
                    *sp = fmaf(e_last, *sp, acc[i]);
                }
            }
        }
    }

    // a thread owns the same state entries in every phase: no sync needed
    for (int n = ty; n < N; n += 16)
        s_out[((static_cast<long long>(b) * H + h) * N + n) * P + p0 + tx] =
            sS[n * PT + tx];
}

int launch_ssd(const float* x, const float* dt, const float* A,
               const float* B, const float* C, const float* h0, float* y,
               float* s_out, int Bt, int T, int H, int G, int N, int P,
               cudaStream_t stream) {
    const int bytes = smem_floats(N) * static_cast<int>(sizeof(float));
    static int opted_in[kMaxDevices] = {};    // bytes allowed, per card
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= kMaxDevices)
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorInvalidDevice);
    if (bytes > opted_in[dev]) {
        err = cudaFuncSetAttribute(
            ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[dev] = bytes;
    }
    const long long blocks = static_cast<long long>(Bt) * H * (P / PT);
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    ssd_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                      stream>>>(x, dt, A, B, C, h0, y, s_out, T, H, G, N, P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_ssd_scan_f32(const float* x, const float* dt,
                                  const float* A, const float* B,
                                  const float* C, const float* h0, float* y,
                                  float* s_out, int Bt, int T, int H, int G,
                                  int N, int P, cudaStream_t stream) {
    if (Bt <= 0 || H <= 0) return 0;
    if (T < 0 || G <= 0 || H % G != 0 || N <= 0 || N % 16 != 0 || N > 128
        || P <= 0 || P % PT != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_ssd(x, dt, A, B, C, h0, y, s_out, Bt, T, H, G, N, P,
                      stream);
}
