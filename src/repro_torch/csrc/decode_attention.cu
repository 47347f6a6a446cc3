// One-token decode attention over a KV cache: GQA, per-row cache length,
// sliding window, logit soft-capping, float32 throughout.
//
// Replaces the Pallas kernel of src/repro/kernels/decode_attention.py
// (`decode_attention`, `_dec_kernel`). The Pallas grid (batch·q-head,
// cache tile) sweeps the cache in order on one core for each q head,
// skipping tiles outside the live range read from the per-row length
// (scalar prefetch). On this card the blocks run in no order on 132 SMs,
// so the cache is split by work (flash-decoding with fixed-size shares):
//
// * Grid (b·kv-head·head-group, share). A block owns up to RB q heads of
//   one kv head (K and V are read once for all of them; RB = the next
//   power of two of Hq/Hkv, at most 8, more groups past that) and the
//   share [lo + j·L, lo + (j+1)·L) of the row's LIVE range [lo, hi),
//   hi = min(len, S), lo = max(len - window, 0) (the window starts from
//   the raw length, as the Pallas kernel's does, also past S; a row with
//   lo >= hi has no share to stream). L comes from the host's
//   plan (kernels/decode_attention.py `_plan`), which never reads the
//   lengths: the grid is the upper bound ceil(min(S, window)/L) shares,
//   and a block whose share starts past its row's live range exits at
//   once. So every busy block streams the same bytes, and the number of
//   busy blocks follows the live total, whatever the lengths.
// * Bytes in flight: each warp streams its own steps of the share (step
//   t, of PS positions, to warp t mod 4) through a private ring of 3
//   stages filled by cp.async (16 bytes a lane, neighbouring lanes on
//   neighbouring addresses of a K or V row); a warp waits on its own
//   copies and __syncwarp, so no block-wide barrier runs per tile. A
//   stage is 2 KB of K and 2 KB of V: 2 stages in flight a warp, 8 a
//   block, 4 blocks an SM (48 KB of shared memory each) keep ~128 KB of
//   loads outstanding an SM, well above the ~40 KB that 3.35 TB/s needs
//   at device-memory latency over 132 SMs. (4 stages at 3 blocks an SM
//   read slower on the H100 in development runs: the warps' softmax,
//   not the loads in flight, is what more resident warps hide.)
// * Every lane busy at every rep: lanes map to D (LP lanes a position,
//   NC float4 each: 16 x 1 at D <= 64, so a warp holds two positions at
//   once; 32 x 1 at D <= 128; 32 x 2 at D <= 256), warps to positions.
//   q's RB rows sit in registers; a score is a dot of the lane's columns
//   reduced over the LP lanes by shuffles, each score its own chain (a
//   reduce-scatter that shares the scores out over the lanes halved the
//   shuffles but read slower at rep 4 on the H100: a longer chain).
//   Scores and exponents are to base 2 (q·scale, then ·log2 e after the
//   softcap). Each warp keeps its own online-softmax state (the max
//   shared by the warp, one rescale a stage), merged once at the
//   block's end in shared memory.
// * The merge of the shares is folded into the same launch by a
//   last-block ticket: each busy block writes its partial (max, sum,
//   unnormalised output per head) to the scratch, then takes a ticket
//   of its (row, kv head, group) by an acq_rel atomic add; the block
//   that takes the last one (ceil(live/L) tickets, counted from the
//   device length) merges the row's partials in share order (one exp2 a
//   partial) and sets the ticket back to 0 for the next call. (A merge
//   as a second launch, and a __threadfence before the ticket, read
//   slower on the H100 in development runs.)
//   A row with no visible position gives exactly 0, as the Pallas
//   kernel does (its share-0 block writes it).
//
// Masks as in the Pallas kernel: softcap before the mask, visible iff
// lo <= pos < hi (JAX: `pos < clen` and `pos >= clen - window`).
//
// Bound on this card: bytes. A position costs 4·D·rep FLOPs against
// 8·D bytes of K and V, 0.5 FLOP/byte at rep 1 and 2 at rep 4, far below
// the card's fp32 ridge of ~20 (67 TFLOP/s over 3.35 TB/s), so the
// arithmetic stays fp32 on the CUDA cores (no tensor cores, no split)
// and the kernel lives on the bytes it keeps in flight.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;              // ring stages a warp
constexpr int kSlots = 128;             // float4 of K (and of V) a stage
constexpr int kMinBlocks = 4;           // blocks an SM holds (48 KB each)
constexpr int kMaxShares = 256;         // the plan's cap on ceil(span / L)
constexpr int kMaxHeads = 8;            // q heads a block holds (RB)
constexpr float NEG_INF = -1e30f;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy(float4& a, float p, float4 v) {
    a.x = fmaf(p, v.x, a.x);
    a.y = fmaf(p, v.y, a.y);
    a.z = fmaf(p, v.z, a.z);
    a.w = fmaf(p, v.w, a.w);
}

__device__ __forceinline__ void scale4(float4& a, float s) {
    a.x *= s; a.y *= s; a.z *= s; a.w *= s;
}

// Shared memory of a block, in bytes: the warps' rings, or (reusing
// them once drained) the warps' states for the block's merge and the
// weights of the shares' merge; `lpnc` float4 a row (LP·NC), RB heads.
// kernels/decode_attention.py smem_bytes counts the same
// (repro_decode_smem_bytes reports it to the card's test of that).
constexpr int smem_ring() { return kWarps * kStages * 2 * kSlots * 16; }
constexpr int smem_merge(int lpnc, int rb) {
    return 4 * (kWarps * rb * lpnc * 4 + 2 * kWarps * rb
                + rb * kMaxShares + rb);
}
constexpr int smem_bytes(int lpnc, int rb) {
    return smem_ring() > smem_merge(lpnc, rb) ? smem_ring()
                                              : smem_merge(lpnc, rb);
}

// The row's output from its `busy` partials: o = Σ w_s·acc_s / Σ w_s·l_s,
// w_s = 2^(m_s - M), in share order (a warp a head for M and the sum,
// then every thread over (head, column), its first partials loaded
// before the weights are known). All threads of the block call it.
// `sW` holds RB × kMaxShares weights, `sInv` RB floats.
template <int RB>
__device__ void merge_shares(const float* __restrict__ pml,
                             const float* __restrict__ pacc,
                             float* __restrict__ o, long long orow, int nh,
                             int busy, int shares, int D, float* sW,
                             float* sInv) {
    constexpr int kAhead = 16;          // partials a thread loads at once
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int V4 = D / 4;
    // element f = (head, float4 column); its partials from share s on
    auto load = [&](int f, int s, float4 (&x)[kAhead]) {
        const float4* src = reinterpret_cast<const float4*>(
            pacc + (orow + f / V4) * shares * D) + f % V4;
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
            if (s + u < busy) x[u] = __ldcg(src + (s + u) * V4);
    };
    float4 x[kAhead];
    if (threadIdx.x < nh * V4) load(threadIdx.x, 0, x);
    for (int r = warp; r < nh; r += kWarps) {
        const float* ml = pml + 2 * (orow + r) * shares;
        float M = NEG_INF;
        for (int s = lane; s < busy; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
        for (int off = 16; off > 0; off >>= 1)
            M = fmaxf(M, __shfl_xor_sync(kFull, M, off));
        float l = 0.0f;
        for (int s = lane; s < busy; s += 32) {
            const float w = exp2f(__ldcg(ml + 2 * s) - M);
            sW[r * kMaxShares + s] = w;
            l = fmaf(w, __ldcg(ml + 2 * s + 1), l);
        }
        for (int off = 16; off > 0; off >>= 1)
            l += __shfl_xor_sync(kFull, l, off);
        if (lane == 0) sInv[r] = 1.0f / fmaxf(l, 1e-30f);
    }
    __syncthreads();
    for (int f = threadIdx.x; f < nh * V4; f += kThreads) {
        const float* w = sW + f / V4 * kMaxShares;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < busy; s += kAhead) {
            if (s > 0 || f != threadIdx.x) load(f, s, x);
#pragma unroll
            for (int u = 0; u < kAhead; ++u)
                if (s + u < busy) axpy(a, w[s + u], x[u]);
        }
        scale4(a, sInv[f / V4]);
        reinterpret_cast<float4*>(o + (orow + f / V4) * D)[f % V4] = a;
    }
}

// LP lanes a position, NC float4 a lane (LP·NC float4 a stored row, at
// least D/4), RB q heads a block.
template <int LP, int NC, int RB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_share_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, const int* __restrict__ lens,
                    float* __restrict__ pml, float* __restrict__ pacc,
                    int* __restrict__ tickets, float* __restrict__ o, int S,
                    int Hq, int Hkv, int D, int L, int shares, int window,
                    float softcap, float scale) {
    constexpr int G = 32 / LP;          // positions a warp holds at once
    constexpr int LPNC = LP * NC;       // float4 a stored row
    constexpr int PS = kSlots / LPNC;   // positions a stage
    constexpr int U = PS / G;           // of them, a lane group's
    extern __shared__ float4 smem4[];
    __shared__ int last;

    const int rep = Hq / Hkv;
    const int ng = (rep + RB - 1) / RB;
    const int bk = blockIdx.x / ng, grp_h = blockIdx.x % ng;
    const int b = bk / Hkv, hk = bk % Hkv;
    const int nh = min(RB, rep - grp_h * RB);
    const long long orow =
        static_cast<long long>(b) * Hq + hk * rep + grp_h * RB;
    const int j = blockIdx.y;
    const int V4 = D / 4;

    const int len = lens[b];
    const int hi = max(min(len, S), 0);
    const int lo = window > 0 ? max(len - window, 0) : 0;
    const int busy = hi > lo ? (hi - lo + L - 1) / L : 0;
    if (j >= busy) {
        if (j == 0)                     // no visible position: 0
            for (int f = threadIdx.x; f < nh * V4; f += kThreads)
                reinterpret_cast<float4*>(o + orow * D)[f] =
                    make_float4(0.f, 0.f, 0.f, 0.f);
        return;
    }
    const int c0 = lo + j * L;
    const int c1 = min(c0 + L, hi);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int grp = lane / LP, jl = lane % LP;

    float4 qr[RB][NC];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int col = jl + LP * c;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < nh && col < V4) {
                x = reinterpret_cast<const float4*>(q + (orow + r) * D)[col];
                scale4(x, scale);
            }
            qr[r][c] = x;
        }

    // this warp's ring: kStages × (K stage, V stage) of kSlots float4
    float4* ring = smem4 + warp * kStages * 2 * kSlots;
    const long long rs = static_cast<long long>(Hkv) * D;
    const long long base = (static_cast<long long>(b) * S * Hkv + hk) * D;
    const float* kb = kc + base;
    const float* vb = vc + base;
    const int steps = (c1 - c0 + PS - 1) / PS;
    const int mine = steps > warp ? (steps - warp + kWarps - 1) / kWarps : 0;

    // copy my i-th step (positions c0 + t·PS ..., t = warp + 4i) into
    // stage i mod kStages; slots past D/4 or past the share read nothing
    // and hold zeros
    auto issue = [&](int i) {
        float4* st = ring + (i % kStages) * 2 * kSlots;
        const int p0 = c0 + (warp + i * kWarps) * PS;
#pragma unroll
        for (int e = 0; e < kSlots / 32; ++e) {
            const int s = lane + 32 * e;
            const int p = s / LPNC, col = s % LPNC;
            const bool ok = col < V4 && p0 + p < c1;
            const long long off = ok ? (p0 + p) * rs + 4 * col : 0;
            cp_async16(st + s, kb + off, ok);
            cp_async16(st + kSlots + s, vb + off, ok);
        }
    };

    float m[RB], l[RB];
    float4 acc[RB][NC];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < mine) issue(i);
        cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
        cp_async_wait<kStages - 2>();
        __syncwarp();       // stage i landed for all lanes; i - 1 is free
        if (i + kStages - 1 < mine) issue(i + kStages - 1);
        cp_async_commit();
        const float4* sk = ring + (i % kStages) * 2 * kSlots;
        const float4* sv = sk + kSlots;
        const int p0 = c0 + (warp + i * kWarps) * PS;

        float s[U][RB];
        bool vis[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int p = u * G + grp;
            vis[u] = p0 + p < c1;
            float4 kk[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) kk[c] = sk[p * LPNC + jl + LP * c];
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                float a = 0.0f;
#pragma unroll
                for (int c = 0; c < NC; ++c) a = dot(qr[r][c], kk[c], a);
                s[u][r] = a;
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                float a = s[u][r];
#pragma unroll
                for (int off = LP / 2; off > 0; off >>= 1)
                    a += __shfl_xor_sync(kFull, a, off);
                if (softcap > 0.0f) a = softcap * tanhf(a / softcap);
                s[u][r] = vis[u] ? a * kLog2e : NEG_INF;
            }
        // online softmax, the max shared by the warp's lane groups
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float mx = s[0][r];
#pragma unroll
            for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][r]);
#pragma unroll
            for (int off = 16; off >= LP; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
            const float m_new = fmaxf(m[r], mx);
            if (m_new > m[r]) {         // uniform across the warp
                const float alpha = exp2f(m[r] - m_new);
                l[r] *= alpha;
#pragma unroll
                for (int c = 0; c < NC; ++c) scale4(acc[r][c], alpha);
                m[r] = m_new;
            }
            float sum = 0.0f;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const float p = vis[u] ? exp2f(s[u][r] - m_new) : 0.0f;
                s[u][r] = p;
                sum += p;
            }
            l[r] += sum;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int p = u * G + grp;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 vv = sv[p * LPNC + jl + LP * c];
#pragma unroll
                for (int r = 0; r < RB; ++r) axpy(acc[r][c], s[u][r], vv);
            }
        }
    }
    cp_async_wait<0>();
    // the lane groups' sums (their max is the warp's already)
#pragma unroll
    for (int off = 16; off >= LP; off >>= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            l[r] += __shfl_xor_sync(kFull, l[r], off);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                acc[r][c].x += __shfl_xor_sync(kFull, acc[r][c].x, off);
                acc[r][c].y += __shfl_xor_sync(kFull, acc[r][c].y, off);
                acc[r][c].z += __shfl_xor_sync(kFull, acc[r][c].z, off);
                acc[r][c].w += __shfl_xor_sync(kFull, acc[r][c].w, off);
            }
        }

    // the block's merge of its warps, in shared memory (the rings drained)
    __syncthreads();
    float* sAcc = reinterpret_cast<float*>(smem4);   // kWarps × RB rows
    float* sM = sAcc + kWarps * RB * LPNC * 4;       // kWarps × RB
    float* sE = sM + kWarps * RB;                    // kWarps × RB
    float* sW = sE + kWarps * RB;                    // RB × kMaxShares
    float* sInv = sW + RB * kMaxShares;              // RB
    if (grp == 0)
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
                reinterpret_cast<float4*>(sAcc + (warp * RB + r) * LPNC * 4)
                    [jl + LP * c] = acc[r][c];
    if (lane == 0)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            sM[warp * RB + r] = m[r];
            sE[warp * RB + r] = l[r];
        }
    __syncthreads();
    if (threadIdx.x < nh) {             // the block's max and sum, a head
        const int r = threadIdx.x;
        float M = NEG_INF;
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * RB + r]);
        float lsum = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
            const float e = exp2f(sM[w * RB + r] - M);
            lsum = fmaf(e, sE[w * RB + r], lsum);
            sM[w * RB + r] = e;         // now the warp's weight
        }
        const long long row = (orow + r) * shares + j;
        pml[2 * row] = M;
        pml[2 * row + 1] = lsum;
    }
    __syncthreads();
    for (int f = threadIdx.x; f < nh * V4; f += kThreads) {
        const int r = f / V4, c = f % V4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < kWarps; ++w)
            axpy(a, sM[w * RB + r],
                 reinterpret_cast<const float4*>(
                     sAcc + (w * RB + r) * LPNC * 4)[c]);
        reinterpret_cast<float4*>(pacc + ((orow + r) * shares + j) * D)[c] = a;
    }

    // the last block of the row merges the shares: the ticket's add
    // releases this block's partial (ordered before it by the barrier)
    // and acquires the others'
    __syncthreads();
    if (threadIdx.x == 0) {
        int prev;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(prev) : "l"(tickets + blockIdx.x) : "memory");
        last = prev == busy - 1;
    }
    __syncthreads();
    if (!last) return;
    merge_shares<RB>(pml, pacc, o, orow, nh, busy, shares, D, sW, sInv);
    if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

template <int LP, int NC, int RB>
int launch_decode(const float* q, const float* kc, const float* vc,
                  const int* lens, float* o, float* part, int* tickets,
                  int B, int S, int Hq, int Hkv, int D, int L, int shares,
                  int window, float softcap, float scale, int device,
                  cudaStream_t stream) {
    constexpr int bytes = smem_bytes(LP * NC, RB);
    static bool opted_in[kMaxDevices] = {};
    if (!opted_in[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            decode_share_kernel<LP, NC, RB>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[device] = true;
    }
    const int ng = (Hq / Hkv + RB - 1) / RB;
    const long long blocks = static_cast<long long>(B) * Hkv * ng;
    const long long rows = static_cast<long long>(B) * Hq * shares;
    float* pacc = part;                 // (B·Hq·shares) × D
    float* pml = part + rows * D;       // (B·Hq·shares) × (max, sum)
    decode_share_kernel<LP, NC, RB>
        <<<dim3(static_cast<unsigned>(blocks), shares), kThreads, bytes,
            stream>>>(q, kc, vc, lens, pml, pacc, tickets, o, S, Hq, Hkv, D,
                      L, shares, window, softcap, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int LP, int NC>
int by_heads(int rb, const float* q, const float* kc, const float* vc,
             const int* lens, float* o, float* part, int* tickets, int B,
             int S, int Hq, int Hkv, int D, int L, int shares, int window,
             float softcap, float scale, int device, cudaStream_t stream) {
#define REPRO_DEC_HEADS(RB_)                                               \
    if (rb == RB_)                                                         \
        return launch_decode<LP, NC, RB_>(q, kc, vc, lens, o, part,       \
            tickets, B, S, Hq, Hkv, D, L, shares, window, softcap, scale,  \
            device, stream);
    REPRO_DEC_HEADS(1)
    REPRO_DEC_HEADS(2)
    REPRO_DEC_HEADS(4)
    REPRO_DEC_HEADS(8)
#undef REPRO_DEC_HEADS
    return static_cast<int>(cudaErrorInvalidValue);
}

// q heads a block holds: the next power of two of rep, at most kMaxHeads
// (kernels/decode_attention.py head_block).
int head_block(int rep) {
    int rb = 1;
    while (rb < rep && rb < kMaxHeads) rb *= 2;
    return rb;
}

// float4 a stored K or V row (LP·NC) at head width D
// (kernels/decode_attention.py row_slots).
int row_slots(int D) { return D <= 64 ? 16 : D <= 128 ? 32 : 64; }

}  // namespace

// Bytes of shared memory a block takes at head width D and rep q heads a
// kv head.
extern "C" int repro_decode_smem_bytes(int D, int rep) {
    return smem_bytes(row_slots(D), head_block(rep));
}

// `part` holds B·Hq·shares·(D + 2) floats (the unnormalised outputs,
// then the max and sum of each); `tickets` B·Hkv·ceil(rep/RB)
// ints, all 0 (the kernel leaves them so); `L` and `shares` from the
// plan, shares ≥ ceil(min(S, window or S) / L).
extern "C" int repro_decode_attention_f32(
        const float* q, const float* kc, const float* vc, const int* lens,
        float* o, float* part, int* tickets, int B, int S, int Hq, int Hkv,
        int D, int L, int shares, int window, float softcap, float scale,
        int device, cudaStream_t stream) {
    if (B <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv != 0 || D % 4 != 0 || D <= 0 || D > 256
        || L < 1 || shares < 1 || shares > kMaxShares || device < 0
        || device >= kMaxDevices)
        return static_cast<int>(cudaErrorInvalidValue);
    const int rb = head_block(Hq / Hkv);
    if (D <= 64)
        return by_heads<16, 1>(rb, q, kc, vc, lens, o, part, tickets, B, S,
                               Hq, Hkv, D, L, shares, window, softcap, scale,
                               device, stream);
    if (D <= 128)
        return by_heads<32, 1>(rb, q, kc, vc, lens, o, part, tickets, B, S,
                               Hq, Hkv, D, L, shares, window, softcap, scale,
                               device, stream);
    return by_heads<32, 2>(rb, q, kc, vc, lens, o, part, tickets, B, S, Hq,
                           Hkv, D, L, shares, window, softcap, scale,
                           device, stream);
}
