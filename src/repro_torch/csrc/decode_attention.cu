// One-token decode attention over a KV cache: GQA, per-row cache length,
// sliding window, logit soft-capping, float32 throughout.
//
// Replaces the Pallas kernel of src/repro/kernels/decode_attention.py
// (`decode_attention`, `_dec_kernel`). The Pallas grid (batch·q-head,
// cache tile) sweeps the cache in order on one core for each q head,
// skipping tiles outside the live range read from the per-row length
// (scalar prefetch). On this card one query row per q head is far too
// little work for a block, and the cache is the only large operand, so
// the split is by kv head and by cache range (flash-decoding):
//
// * Pass 1: one block per (b·kv-head, split). The block owns the
//   Hq/Hkv q heads that share its kv head (K and V are read once for
//   all of them) and a contiguous share of the row's LIVE range
//   [lo, hi), hi = len, lo = max(len - window, 0) — the length read
//   from the device tensor, so nothing beyond the live range is ever
//   loaded and no host sync is needed. It streams 32-position K and V
//   tiles through shared memory and keeps, per q head, the running max,
//   sum and output accumulator (online softmax), which it writes as one
//   partial result.
// * Pass 2: one block per (b·q-head) merges the partials:
//   M = max m_s, L = Σ e^(m_s - M)·l_s, o = Σ e^(m_s - M)·acc_s / max(L,
//   1e-30). An empty share contributes m = -1e30, l = 0, acc = 0.
//
// Masks as in the Pallas kernel: softcap before the mask, visible iff
// lo <= pos < len (JAX: `pos < clen` and `pos >= clen - window`). A row
// with no visible position gives 0, as the Pallas kernel does.
//
// Bound on this card: bytes (each live K and V row read once; the
// scores and the weighted sum are 4·D operations per position and q
// head, far below the bytes' time). Shared memory: rep·D·2 + 32·(D+4) +
// 32·D + rep·32 + 3·rep floats, opted in above 48 KB.
#include "common.cuh"

namespace {

constexpr int TS = 32;                  // cache positions per tile
constexpr int kThreads = 128;
constexpr float NEG_INF = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, const int* __restrict__ lens,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int Hq, int Hkv,
                    int D, int n_split, int window, float softcap,
                    float scale) {
    const int rep = Hq / Hkv;
    const int V4 = D / 4;
    const int KS = D + 4;               // padded K row stride
    extern __shared__ float4 smem4[];
    float* sQ = reinterpret_cast<float*>(smem4);   // rep × D
    float* sAcc = sQ + rep * D;                    // rep × D
    float* sK = sAcc + rep * D;                    // TS × (D + 4)
    float* sV = sK + TS * KS;                      // TS × D
    float* sS = sV + TS * D;                       // rep × TS
    float* sM = sS + rep * TS;                     // rep
    float* sL = sM + rep;                          // rep
    float* sA = sL + rep;                          // rep

    const int bk = blockIdx.x;                     // b · Hkv + hk
    const int b = bk / Hkv, hk = bk % Hkv;
    const int split = blockIdx.y;
    const int hi = min(lens[b], S);
    const int lo = window > 0 ? max(hi - window, 0) : 0;
    const int n = max(hi - lo, 0);
    const int chunk = (n + n_split - 1) / n_split;
    const int c0 = lo + split * chunk;
    const int c1 = min(c0 + chunk, hi);

    const float* qb = q + (static_cast<long long>(b) * Hq + hk * rep) * D;
    for (int f = threadIdx.x; f < rep * V4; f += kThreads) {
        float4 x = reinterpret_cast<const float4*>(qb)[f];
        x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
        reinterpret_cast<float4*>(sQ)[f] = x;
        reinterpret_cast<float4*>(sAcc)[f] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = threadIdx.x; r < rep; r += kThreads) {
        sM[r] = NEG_INF;
        sL[r] = 0.0f;
    }
    const long long row_stride = static_cast<long long>(Hkv) * D;
    const float* kb = kc + (static_cast<long long>(b) * S * Hkv + hk) * D;
    const float* vb = vc + (static_cast<long long>(b) * S * Hkv + hk) * D;

    for (int t0 = c0; t0 < c1; t0 += TS) {
        const int nt = min(TS, c1 - t0);
        __syncthreads();                // previous tile fully consumed
        for (int f = threadIdx.x; f < nt * V4; f += kThreads) {
            const int r = f / V4, c = f % V4;
            const long long g = (t0 + r) * row_stride;
            reinterpret_cast<float4*>(sK + r * KS)[c] =
                reinterpret_cast<const float4*>(kb + g)[c];
            reinterpret_cast<float4*>(sV + r * D)[c] =
                reinterpret_cast<const float4*>(vb + g)[c];
        }
        __syncthreads();
        for (int f = threadIdx.x; f < rep * TS; f += kThreads) {
            const int r = f / TS, i = f % TS;
            float s = NEG_INF;
            if (i < nt) {
                const float4* qr = reinterpret_cast<const float4*>(sQ + r * D);
                const float4* kr = reinterpret_cast<const float4*>(sK + i * KS);
                float a = 0.0f;
                for (int c = 0; c < V4; ++c) a = dot4(qr[c], kr[c], a);
                s = softcap > 0.0f ? softcap * tanhf(a / softcap) : a;
            }
            sS[f] = s;
        }
        __syncthreads();
        // online softmax per q head: one warp per head, one lane per
        // position of the tile (TS == 32)
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        for (int r = warp; r < rep; r += kThreads / 32) {
            const float s = sS[r * TS + lane];
            float mx = s;
            for (int o = 16; o > 0; o >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_old = sM[r];
            const float m_new = fmaxf(m_old, mx);
            const float p = lane < nt ? expf(s - m_new) : 0.0f;
            sS[r * TS + lane] = p;
            float sum = p;
            for (int o = 16; o > 0; o >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                sA[r] = alpha;
                sL[r] = alpha * sL[r] + sum;
                sM[r] = m_new;
            }
        }
        __syncthreads();
        for (int f = threadIdx.x; f < rep * V4; f += kThreads) {
            const int r = f / V4, c = f % V4;
            const float alpha = sA[r];
            float4 a = reinterpret_cast<float4*>(sAcc)[f];
            a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
            const float* pr = sS + r * TS;
            for (int i = 0; i < nt; ++i) {
                const float p = pr[i];
                const float4 vv = reinterpret_cast<const float4*>(sV + i * D)[c];
                a.x = fmaf(p, vv.x, a.x);
                a.y = fmaf(p, vv.y, a.y);
                a.z = fmaf(p, vv.z, a.z);
                a.w = fmaf(p, vv.w, a.w);
            }
            reinterpret_cast<float4*>(sAcc)[f] = a;
        }
    }
    __syncthreads();
    // partial result of each q head of this block: (b·Hq + h, split)
    for (int f = threadIdx.x; f < rep * V4; f += kThreads) {
        const int r = f / V4, c = f % V4;
        const long long row =
            (static_cast<long long>(b) * Hq + hk * rep + r) * n_split + split;
        reinterpret_cast<float4*>(part_acc + row * D)[c] =
            reinterpret_cast<const float4*>(sAcc)[f];
    }
    for (int r = threadIdx.x; r < rep; r += kThreads) {
        const long long row =
            (static_cast<long long>(b) * Hq + hk * rep + r) * n_split + split;
        part_m[row] = sM[r];
        part_l[row] = sL[r];
    }
}

__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, float* __restrict__ o,
                    int D, int n_split) {
    const long long bh = blockIdx.x;
    const float* pm = part_m + bh * n_split;
    const float* pl = part_l + bh * n_split;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[s]);
    float L = 0.0f;
    for (int s = 0; s < n_split; ++s) L += expf(pm[s] - M) * pl[s];
    const float inv = 1.0f / fmaxf(L, 1e-30f);
    for (int d = threadIdx.x; d < D; d += kThreads) {
        float a = 0.0f;
        for (int s = 0; s < n_split; ++s)
            a = fmaf(expf(pm[s] - M), part_acc[(bh * n_split + s) * D + d], a);
        o[bh * D + d] = a * inv;
    }
}

int smem_bytes(int rep, int D) {
    return (2 * rep * D + TS * (D + 4) + TS * D + rep * TS + 3 * rep)
           * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" int repro_decode_attention_f32(
        const float* q, const float* kc, const float* vc, const int* lens,
        float* o, float* part_m, float* part_l, float* part_acc, int B, int S,
        int Hq, int Hkv, int D, int n_split, int window, float softcap,
        float scale, cudaStream_t stream) {
    if (B <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv != 0 || D % 4 != 0 || n_split < 1
        || n_split > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = smem_bytes(Hq / Hkv, D);
    // the most dynamic shared memory allowed so far, per card
    static int opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= kMaxDevices)
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorInvalidDevice);
    if (bytes > 48 * 1024 && bytes > opted_in[dev]) {
        err = cudaFuncSetAttribute(
            decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[dev] = bytes;
    }
    decode_split_kernel<<<dim3(B * Hkv, n_split), kThreads, bytes, stream>>>(
        q, kc, vc, lens, part_m, part_l, part_acc, S, Hq, Hkv, D, n_split,
        window, softcap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_merge_kernel<<<B * Hq, kThreads, 0, stream>>>(
        part_m, part_l, part_acc, o, D, n_split);
    return static_cast<int>(cudaGetLastError());
}
