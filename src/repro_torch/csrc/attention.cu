// Flash attention forward: GQA, causal (offset Tk - Tq), sliding window,
// logit soft-capping, float32 throughout.
//
// Replaces the Pallas kernel of src/repro/kernels/attention.py (`mha`,
// `_attn_kernel`). The Pallas grid (batch·q-head, q tile, kv tile) runs
// the kv axis in order on one core and carries the online-softmax
// statistics in VMEM scratch from one grid step to the next. Blocks on
// this card run in no order, so the kv sweep is a loop inside the block:
// one block per (b·q-head, 64-row q tile) keeps its q tile in shared
// memory and streams 64-key K and V tiles through one shared buffer,
// with the running max, sum and output accumulator in registers.
//
// * GQA: q head h reads kv head h / (Hq / Hkv) by index; K/V are never
//   repeated.
// * Masks as in the Pallas kernel: NEG_INF = -1e30, softcap before the
//   mask, causal `ki <= qi` with qi = q position + (Tk - Tq), window
//   `ki > qi - window`, the output divided by max(l, 1e-30). A masked
//   score contributes exactly 0 (the Pallas exp(-1e30 - m) underflows
//   to the same 0 whenever its row has a visible key).
// * Kv tiles wholly outside the q tile's visible range are never
//   loaded (the Pallas `pl.when(visible)` skip); q tiles are issued
//   longest first, so a causal grid ends on its short tiles.
// * Ragged Tq and Tk are predicated (zero-filled rows, masked keys); no
//   padded copy is made.
//
// Thread layout: 256 threads as 16 x 16 (ty, tx). A thread owns rows
// ty + 16·i (i < 4) of the tile, score columns tx + 16·j (j < 4), and
// output columns 4·tx + 64·j .. +3 (j < D/64), so each row's softmax
// statistics live in the 16 lanes that share ty and reduce with
// shuffles. Shared rows are padded to D + 4 floats: 16-byte reads of
// eight consecutive rows then hit 32 distinct banks.
//
// Bound on this card: operations (4·Tq·Tk·D per head, halved by a
// causal mask, over the 67 TFLOP/s fp32 peak; no tensor cores, no TF32,
// no fast math). Shared memory: 64·(D+4)·2 + 64·68 floats (85 KB at
// D = 128, 150 KB at D = 256), above the 48 KB default, so the launch
// opts in with cudaFuncSetAttribute.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float NEG_INF = -1e30f;
constexpr int kMaxDevices = 64;

template <int D>
constexpr int smem_floats() {
    return BQ * (D + 4) + BK * (D + 4) + BQ * (BK + 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

// Rows [r0, r0 + rows) of a (T, H, D) stream at head h → shared rows of
// stride D + 4, times `mul`; rows at or past T are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int T,
                                          int row_stride, float mul) {
    constexpr int V = D / 4;
    for (int f = threadIdx.x; f < rows * V; f += kThreads) {
        const int r = f / V, c = f % V;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < T) {
            v = reinterpret_cast<const float4*>(
                src + static_cast<long long>(r0 + r) * row_stride)[c];
            v.x *= mul; v.y *= mul; v.z *= mul; v.w *= mul;
        }
        reinterpret_cast<float4*>(dst + r * (D + 4))[c] = v;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int Tq,
           int Tk, int Hq, int Hkv, int causal, int window, float softcap,
           float scale) {
    constexpr int DS = D + 4;           // padded row stride
    constexpr int PS = BK + 4;
    constexpr int NJ = D / 64;          // 4-float output groups per thread
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);
    float* sKV = sQ + BQ * DS;
    float* sP = sKV + BK * DS;

    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
    const int off = Tk - Tq;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

    const float* qb = q + (static_cast<long long>(b) * Tq * Hq + h) * D;
    const float* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
    const float* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
    load_tile<D>(sQ, qb, q0, BQ, Tq, Hq * D, scale);

    // the kv range any valid row of this tile can see
    const int q_last = min(q0 + BQ, Tq) - 1;
    int k_hi = causal ? min(Tk, q_last + off + 1) : Tk;
    int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;

    float m[4], l[4], acc[4][NJ][4];
    int qi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.0f;
        qi[i] = q0 + ty + 16 * i + off;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
    }

    for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
        __syncthreads();                // sKV and sP free (and sQ loaded)
        load_tile<D>(sKV, kb, k0, BK, Tk, Hkv * D, 1.0f);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(
                    sQ + (ty + 16 * i) * DS + d);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(
                    sKV + (tx + 16 * j) * DS + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = NEG_INF;
            bool vis[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int ki = k0 + tx + 16 * j;
                vis[j] = ki < Tk && (!causal || ki <= qi[i])
                         && (window <= 0 || ki > qi[i] - window);
                float x = s[i][j];
                if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
                s[i][j] = vis[j] ? x : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
                sP[(ty + 16 * i) * PS + tx + 16 * j] = p;
                sum += p;
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, w);
            const float alpha = expf(m[i] - m_new);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
        }

        __syncthreads();                // every score read of K done
        load_tile<D>(sKV, vb, k0, BK, Tk, Hkv * D, 1.0f);
        __syncthreads();

#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = *reinterpret_cast<const float4*>(
                    sP + (ty + 16 * i) * PS + kk);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float* vrow = sKV + (kk + c) * DS + 4 * tx;
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const float4 vv =
                        *reinterpret_cast<const float4*>(vrow + 64 * j);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float p = c == 0 ? pv[i].x : c == 1 ? pv[i].y
                                      : c == 2 ? pv[i].z : pv[i].w;
                        acc[i][j][0] = fmaf(p, vv.x, acc[i][j][0]);
                        acc[i][j][1] = fmaf(p, vv.y, acc[i][j][1]);
                        acc[i][j][2] = fmaf(p, vv.z, acc[i][j][2]);
                        acc[i][j][3] = fmaf(p, vv.w, acc[i][j][3]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty + 16 * i;
        if (qpos >= Tq) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        float* orow = o + ((static_cast<long long>(b) * Tq + qpos) * Hq + h) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            *reinterpret_cast<float4*>(orow + 4 * tx + 64 * j) = make_float4(
                acc[i][j][0] * inv, acc[i][j][1] * inv, acc[i][j][2] * inv,
                acc[i][j][3] * inv);
    }
}

template <int D>
int launch_mha(const float* q, const float* k, const float* v, float* o,
               int B, int Tq, int Tk, int Hq, int Hkv, int causal,
               int window, float softcap, float scale, cudaStream_t stream) {
    const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
    static bool opted_in[kMaxDevices] = {};   // once per instance and card
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= kMaxDevices)
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorInvalidDevice);
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(
            mha_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[dev] = true;
    }
    const dim3 grid((Tq + BQ - 1) / BQ, B * Hq);
    mha_kernel<D><<<grid, kThreads, bytes, stream>>>(
        q, k, v, o, Tq, Tk, Hq, Hkv, causal, window, softcap, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_mha_f32(const float* q, const float* k, const float* v,
                             float* o, int B, int Tq, int Tk, int Hq, int Hkv,
                             int D, int causal, int window, float softcap,
                             float scale, cudaStream_t stream) {
    if (B <= 0 || Tq <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
    case 64:
        return launch_mha<64>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                              softcap, scale, stream);
    case 128:
        return launch_mha<128>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                               softcap, scale, stream);
    case 256:
        return launch_mha<256>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                               softcap, scale, stream);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
