// Flash attention forward: GQA, causal (offset Tk - Tq), sliding window,
// logit soft-capping, float32 in and out, on the TF32 tensor cores at fp32
// accuracy.
//
// Replaces the Pallas kernel of src/repro/kernels/attention.py (`mha` :85,
// `_attn_kernel` :29, pallas_call :117). The Pallas grid (batch·q-head, q
// tile, kv tile) runs the kv axis in order on one core and carries the
// online-softmax statistics in VMEM scratch from one grid step to the
// next. Blocks on this card run in no order, so the kv sweep is a loop
// inside the block: one block per (b·q-head, BQ-row q tile) keeps its q
// tile in shared memory and streams BK-key K and V tiles past it, with the
// running max, sum and output accumulator in registers.
//
// * GQA: q head h reads kv head h / (Hq / Hkv) by index; K/V are never
//   repeated.
// * Masks as in the Pallas kernel: NEG_INF = -1e30, softcap before the
//   mask, causal `ki <= qi` with qi = q position + (Tk - Tq), window
//   `ki > qi - window`, the output divided by max(l, 1e-30). A masked
//   score contributes exactly 0, so a row with no visible key gives 0
//   (the Pallas exp(-1e30 - m) underflows to the same 0 whenever its row
//   has a visible key). `scale` multiplies q before the product, as the
//   Pallas kernel does.
// * Kv tiles wholly outside the q tile's visible range are never loaded
//   (the Pallas `pl.when(visible)` skip); q tiles are issued longest
//   first, so a causal grid ends on its short tiles. A warp skips a loaded
//   tile that none of its 16 rows sees, and takes a path without the
//   per-score mask test where every valid row sees every key of the tile.
//   The softcap is a template argument: its tanh is compiled in only where
//   one is set.
// * Ragged Tq and Tk are predicated (zero-filled rows, masked keys); no
//   padded copy is made.
//
// Arithmetic. Both products, S = (q·scale)·K^T and O += P·V, run on the
// tensor cores (mma.sync m16n8k8 TF32, fragments built by hand). TF32
// keeps 11 significant bits, so every operand is split into two TF32
// values, both rounded to nearest (cvt.rna): hi = tf32(v), lo = tf32(v -
// hi); v - hi is exact in f32 and |v - hi - lo| <= 2^-22 |v|. A product is
// three MMAs, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, each partial product
// exact; what it loses is a_hi (b - b_hi - b_lo) + (a - a_hi - a_lo) b_hi +
// the dropped lo·lo, each <= 2^-22 |a·b| to first order: at most 3·2^-22
// |a·b| (7.2e-7), as in csrc/conv2d.cu. q·scale is split once a block (into
// shared memory), K and V once a staged tile (in place, lo beside it), P
// once an 8-key step as it leaves the score registers.
// The tensor cores add with truncation, not rounding, so no chain of MMAs
// carries a running sum: every 8-wide step (8 features of D for S, 8 keys
// for P·V) is one fresh accumulator of its three MMAs (a_hi·b_hi from
// zero, then the two cross terms, 2^-11 of it), added to the running sum
// by an f32 add on the CUDA cores: a score to its f32 sum over D / 8
// steps; a step of P·V to O, which the online-softmax update has already
// scaled by alpha (O = alpha·O + P·V_tile, the tile's P·V added step by
// step in f32). A chain is three MMAs long whatever D and Tk, so the
// truncation costs at most about 2·2^-23 of each step's partial sum, not a
// bias that grows with the sweep. Scores then carry within about 3·2^-22
// sum_d |q'k| of the exact product of the f32 inputs (q' = fl(q·scale)),
// the output the same relative error through P·V, plus f32 rounding of
// the sums, all far inside the 2e-5 the kernel is held to. The row sum l
// adds the f32 probabilities on the CUDA cores, each lane its own keys,
// the quad's four partials added at the end. No --use_fast_math: expf and
// tanhf are the accurate ones.
//
// Fragments (mma.sync m16n8k8, layouts fixed by the PTX ISA): lane (g =
// lane / 4, t = lane % 4) holds A at rows g, g + 8 and columns t, t + 4; B
// at rows t, t + 4 and column g; C at rows g, g + 8 and columns 2t, 2t + 1.
// A warp owns 16 query rows (and, at D = 256, half of the output columns:
// two warps share a row group, each computing its scores in full and P·V
// for its 128 columns, so that a lane's output accumulator stays at 64
// registers).
//   * S: within a slice of 32 features of D, step s (0..3) contracts
//     features 8t + 2s (column t of A, row t of B) and 8t + 2s + 1 (column
//     t + 4): lane t reads features 8t..8t+7 of its q rows and of its key
//     row, two 16-byte loads each a slice, of q and of K alike.
//   * Keys: a sum does not care about its order, so QK^T's B fragment is
//     built from K rows permuted within each 8-key block: column c of an
//     8-key block holds key pi(c), pi(2t) = t, pi(2t + 1) = t + 4. The
//     score accumulator gives lane (g, t) columns 2t, 2t + 1, which are
//     then keys t and t + 4: exactly the A fragment of P·V over the block's
//     keys in natural order (a0 = c0, a1 = c2, a2 = c1, a3 = c3). P never
//     leaves the registers: no shuffle, no shared memory, no barrier. The
//     permutation is made by the copy (key r lands in row 2 (r % 4) + r / 4
//     of its block), and the masks use the permuted index.
//   * P·V: n8 accumulator j of a warp holds output column 32 (j / 4) + 4n
//     + j % 4 at its column n, so lane g reads its B values as one 16-byte
//     load a V row and four accumulators, and lane t ends with the 8
//     adjacent output columns 32 (j / 4) + 8t .. + 7 of its rows, stored 16
//     bytes at a time.
//   * Row max and row sum reduce over the quad (the 4 lanes that share g)
//     with two shuffles: the max at every tile, the sum once at the end.
// Shared rows are D floats, unpadded, their 16-byte chunks swizzled so
// that a quarter warp's 16-byte loads hit 8 distinct bank groups: chunk c
// of row r lies at c ^ (r % 8) in q and K (lanes g, g + 1 of a quarter warp
// read rows g, g + 1 at chunks 2t + h), at c ^ 2 (r % 4) in V (lanes read
// rows t, t + 4 at chunks g). No padding lets two blocks share an SM where
// the tile is small enough.
//
// Staging. K and V tiles come in by cp.async, 16 bytes at a time, into
// STAGES slots each (zero-filled past Tk), all but one in flight ahead of
// the tile contracted. A tile, once landed, is split in place (the raw
// value becomes hi) with lo written to one buffer beside the slots; two
// barriers a tile: one that publishes the landed tile and frees the slot
// and lo buffers of the tile before it, one that publishes the split.
// Tiles, stages and warps come from one table per head width
// (kernels/attention.py ATTN_TILES, written into attn_tiles.h at build
// time; its _plan picks the launch's).
//
// Short Tq. Where the (b·q-head, q tile) blocks would fill at most half of
// the card (_plan), the kv sweep of each is split into `splits` chunks of
// whole tiles, blockIdx.z a chunk: each writes its row's O unnormalised,
// m and l to a scratch, and mha_combine_kernel adds the chunks in chunk
// order (no atomics: two launches give the same bits).
//
// Bound on this card, by this route: max(3 · 4·B·Hq·D·(visible pairs) /
// 495 TFLOP/s dense TF32, bytes / 3.35 TB/s) (q, k, v read once, o written
// once; chip_smoke.py prints it, and the fp32 one, 67 TFLOP/s, beside it).
#include <type_traits>

#include "common.cuh"
// REPRO_ATTN_TILES: written into the build by kernels/_build.py from
// kernels/attention.py (ATTN_TILES), the one place the table is kept.
#include "attn_tiles.h"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int kMaxDevices = 64;

template <int D, int BQ, int BK, int STAGES>
struct AttnTile {
    static constexpr int DW = D > 128 ? 2 : 1;   // warps sharing a row group
    static constexpr int WARPS = BQ / 16 * DW;
    static constexpr int THREADS = 32 * WARPS;
    static constexpr int NB = BK / 8;            // 8-key blocks a tile
    static constexpr int SG = NB < 2 ? NB : 2;   // blocks a group in S
    static constexpr int WD = D / DW;            // a warp's output columns
    static constexpr int NJ = WD / 8;            // its n8 accumulators
    static constexpr int CH = D / 4;             // 16-byte chunks a row
    static constexpr int Q_FLOATS = BQ * D;      // q_hi, q_lo each
    static constexpr int KV_FLOATS = BK * D;     // a K or V slot, k_lo, v_lo
    // q_hi, q_lo; STAGES K slots, STAGES V slots; k_lo, v_lo (the same
    // count as kernels/attention.py smem_bytes)
    static constexpr int SMEM =
        4 * (2 * Q_FLOATS + (STAGES + 1) * 2 * KV_FLOATS);
    static_assert(BQ % 16 == 0 && BK % 8 == 0 && D % 32 == 0
                  && WD % 32 == 0 && STAGES >= 2 && NB % SG == 0, "tile");
    static_assert(THREADS <= 1024 && SMEM <= 232448,
                  "a block: 1024 threads, 227 KB of shared memory");
};

// v = hi + lo + O(2^-22 |v|), hi and lo TF32 (as f32 bit patterns in a
// float), both rounded to nearest.
__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
    hi = make_float4(__uint_as_float(to_tf32(v.x)),
                     __uint_as_float(to_tf32(v.y)),
                     __uint_as_float(to_tf32(v.z)),
                     __uint_as_float(to_tf32(v.w)));
    lo = make_float4(__uint_as_float(to_tf32(v.x - hi.x)),
                     __uint_as_float(to_tf32(v.y - hi.y)),
                     __uint_as_float(to_tf32(v.z - hi.z)),
                     __uint_as_float(to_tf32(v.w - hi.w)));
}

__device__ __forceinline__ unsigned bits(float x) {
    return __float_as_uint(x);
}

// The float offset of 16-byte chunk c of row r in a q or K buffer, and in
// a V buffer, of rows of D floats (the swizzles of the note).
template <int D>
__device__ __forceinline__ int qk_at(int r, int c) {
    return r * D + 4 * (c ^ (r & 7));
}
template <int D>
__device__ __forceinline__ int v_at(int r, int c) {
    return r * D + 4 * (c ^ ((r & 3) << 1));
}

// Four floats at p (16-byte aligned), as bit patterns.
__device__ __forceinline__ void load4(const float* p, unsigned (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = bits(v.x);
    x[1] = bits(v.y);
    x[2] = bits(v.z);
    x[3] = bits(v.w);
}

// Eight floats, at row + c0 and row + c1, as bit patterns.
__device__ __forceinline__ void load8(const float* row, int c0, int c1,
                                      unsigned (&x)[8]) {
    unsigned a[4], b[4];
    load4(row + c0, a);
    load4(row + c1, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        x[i] = a[i];
        x[4 + i] = b[i];
    }
}

// The A fragments of one 32-feature slice's four steps from q rows g (at
// `row`) and g + 8 (8 rows on), whose features 8t..8t+3 and 8t+4..8t+7 lie
// at offsets c0, c1: step s takes 8t + 2s as column t and 8t + 2s + 1 as
// column t + 4.
template <int D>
__device__ __forceinline__ void q_frags(const float* row, int c0, int c1,
                                        unsigned (&a)[4][4]) {
    const float4 u0 = *reinterpret_cast<const float4*>(row + c0);
    const float4 u1 = *reinterpret_cast<const float4*>(row + c1);
    const float4 w0 = *reinterpret_cast<const float4*>(row + 8 * D + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(row + 8 * D + c1);
    const float r0[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    const float r1[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int st = 0; st < 4; ++st) {
        a[st][0] = bits(r0[2 * st]);
        a[st][1] = bits(r1[2 * st]);
        a[st][2] = bits(r0[2 * st + 1]);
        a[st][3] = bits(r1[2 * st + 1]);
    }
}

template <int D, int BQ, int BK, int STAGES, bool CAP>
__global__ void __launch_bounds__(AttnTile<D, BQ, BK, STAGES>::THREADS)
mha_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int Tk, int Hq, int Hkv, int causal, int window, float softcap,
              float scale, int splits, float* __restrict__ part) {
    using T = AttnTile<D, BQ, BK, STAGES>;
    constexpr int NB = T::NB, NJ = T::NJ, SG = T::SG;
    extern __shared__ __align__(16) float at_smem[];
    float* const sQh = at_smem;
    float* const sQl = sQh + T::Q_FLOATS;
    float* const sK = sQl + T::Q_FLOATS;                // [STAGES][K]
    float* const sV = sK + STAGES * T::KV_FLOATS;       // [STAGES][V]
    float* const sKl = sV + STAGES * T::KV_FLOATS;
    float* const sVl = sKl + T::KV_FLOATS;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int rg = warp / T::DW;                 // rows 16 rg .. of the tile
    const int dbase = warp % T::DW * T::WD;      // the warp's first column

    const int bh = blockIdx.y;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hkv);
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;    // longest first
    const int off = Tk - Tq;
    const long long q_stride = static_cast<long long>(Hq) * D;
    const long long kv_stride = static_cast<long long>(Hkv) * D;
    const float* qb = q + (static_cast<long long>(b) * Tq * Hq + h) * D;
    const float* kb = k + (static_cast<long long>(b) * Tk * Hkv + hk) * D;
    const float* vb = v + (static_cast<long long>(b) * Tk * Hkv + hk) * D;

    // the kv tiles any valid row of this q tile can see
    const int q_last = min(q0 + BQ, Tq) - 1;
    const int k_hi = causal ? min(Tk, q_last + off + 1) : Tk;
    const int k_lo = window > 0 ? max(0, q0 + off - window + 1) : 0;
    // split `splits` ways (blockIdx.z the chunk), whole tiles a chunk
    const int n_all = max(0, (k_hi + BK - 1) / BK - k_lo / BK);
    const int per = (n_all + splits - 1) / splits;
    const int first = min(n_all, static_cast<int>(blockIdx.z) * per);
    const int kt0 = k_lo / BK + first;
    const int n_tiles = min(n_all - first, per);

    // tile i's K and V rows into slot `slot`; key r of an 8-key block to
    // row 2 (r % 4) + r / 4 of its K block (the permutation pi above)
    auto issue = [&](int i, int slot) {
        const int k0 = (kt0 + i) * BK;
        float* dK = sK + slot * T::KV_FLOATS;
        float* dV = sV + slot * T::KV_FLOATS;
        for (int f = tid; f < BK * T::CH; f += T::THREADS) {
            const int r = f / T::CH, c = f % T::CH;
            const bool ok = k0 + r < Tk;
            const long long src =
                (ok ? static_cast<long long>(k0 + r) * kv_stride : 0) + 4 * c;
            const int pr = (r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1);
            cp_async16(dK + qk_at<D>(pr, c), kb + src, ok);
            cp_async16(dV + v_at<D>(r, c), vb + src, ok);
        }
    };
#pragma unroll 1
    for (int s = 0; s + 1 < STAGES; ++s) {
        if (s < n_tiles) issue(s, s);
        cp_async_commit();
    }

    // q·scale, split once into q_hi, q_lo (rows past Tq are 0)
    for (int f = tid; f < BQ * T::CH; f += T::THREADS) {
        const int r = f / T::CH, c = f % T::CH;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (q0 + r < Tq)
            x = __ldg(reinterpret_cast<const float4*>(
                          qb + static_cast<long long>(q0 + r) * q_stride) + c);
        x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
        float4 hi, lo;
        split4(x, hi, lo);
        *reinterpret_cast<float4*>(sQh + qk_at<D>(r, c)) = hi;
        *reinterpret_cast<float4*>(sQl + qk_at<D>(r, c)) = lo;
    }

    // the warp's rows: its lane's two (g, g + 8) as key positions, and the
    // range of its valid ones
    const int qi0 = q0 + 16 * rg + g + off, qi1 = qi0 + 8;
    const bool live = q0 + 16 * rg < Tq;
    // lane t's features 8t..8t+3, 8t+4..8t+7 of a slice in rows g (mod 8)
    const int c0 = 4 * ((2 * t) ^ g), c1 = 4 * ((2 * t + 1) ^ g);
    const int wa = q0 + 16 * rg + off;
    const int wb = min(q0 + 16 * rg + 15, Tq - 1) + off;

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

#pragma unroll 1
    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();               // tile i landed; tile i - 1 done
        if (i + STAGES - 1 < n_tiles)
            issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
        cp_async_commit();
        float* const Kh = sK + i % STAGES * T::KV_FLOATS;
        float* const Vh = sV + i % STAGES * T::KV_FLOATS;
        // split in place, chunk by chunk (lo at the same offset)
        for (int f = 4 * tid; f < T::KV_FLOATS; f += 4 * T::THREADS) {
            float4 hi, lo;
            split4(*reinterpret_cast<float4*>(Kh + f), hi, lo);
            *reinterpret_cast<float4*>(Kh + f) = hi;
            *reinterpret_cast<float4*>(sKl + f) = lo;
            split4(*reinterpret_cast<float4*>(Vh + f), hi, lo);
            *reinterpret_cast<float4*>(Vh + f) = hi;
            *reinterpret_cast<float4*>(sVl + f) = lo;
        }
        __syncthreads();               // the split published

        const int k0 = (kt0 + i) * BK;
        // does any valid row of the warp see a key of the tile; does every
        // one see every key
        if (!live || (causal && k0 > wb)
            || (window > 0 && k0 + BK - 1 <= wa - window))
            continue;
        const bool whole = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= wa)
                           && (window <= 0 || k0 > wb - window);

        // S = (q·scale)·K^T: columns 2t, 2t + 1 of 8-key block n are keys
        // k0 + 8n + t, k0 + 8n + t + 4; rows g, g + 8
        float sc[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
        for (int sl = 0; sl < D / 32; ++sl) {
            unsigned ah[4][4], al[4][4];
            const int qo = (16 * rg + g) * D + 32 * sl;
            q_frags<D>(sQh + qo, c0, c1, ah);
            q_frags<D>(sQl + qo, c0, c1, al);
#pragma unroll
            for (int n0 = 0; n0 < NB; n0 += SG) {
                unsigned kh[SG][8], kl[SG][8];
#pragma unroll
                for (int u = 0; u < SG; ++u) {
                    const int ko = (8 * (n0 + u) + g) * D + 32 * sl;
                    load8(Kh + ko, c0, c1, kh[u]);
                    load8(sKl + ko, c0, c1, kl[u]);
                }
                // SG 8-key blocks at a time: their 4·SG steps' chains side
                // by side (an MMA's result comes tens of cycles later),
                // each in its own fresh accumulator, then added in step
                // order
                float d[SG][4][4];
#pragma unroll
                for (int u = 0; u < SG; ++u)
#pragma unroll
                    for (int st = 0; st < 4; ++st)
                        mma_tf32_first(d[u][st], ah[st], kh[u][2 * st],
                                       kh[u][2 * st + 1]);
#pragma unroll
                for (int u = 0; u < SG; ++u)
#pragma unroll
                    for (int st = 0; st < 4; ++st)
                        mma_tf32(d[u][st], ah[st], kl[u][2 * st],
                                 kl[u][2 * st + 1]);
#pragma unroll
                for (int u = 0; u < SG; ++u)
#pragma unroll
                    for (int st = 0; st < 4; ++st)
                        mma_tf32(d[u][st], al[st], kh[u][2 * st],
                                 kh[u][2 * st + 1]);
#pragma unroll
                for (int u = 0; u < SG; ++u)
#pragma unroll
                    for (int st = 0; st < 4; ++st)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            sc[n0 + u][e] += d[u][st][e];
            }
        }

        // online softmax over the tile; MASKED: the per-score test
        auto softmax = [&](auto masked_c) {
            constexpr bool MASKED = decltype(masked_c)::value;
            auto visible = [&](int n, int e) {
                const int ki = k0 + 8 * n + t + 4 * (e & 1);
                const int qi = e < 2 ? qi0 : qi1;
                return ki < Tk && (!causal || ki <= qi)
                       && (window <= 0 || ki > qi - window);
            };
            float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
            for (int n = 0; n < NB; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = sc[n][e];
                    if constexpr (CAP) x = softcap * tanhf(x / softcap);
                    if constexpr (MASKED) x = visible(n, e) ? x : NEG_INF;
                    sc[n][e] = x;
                    mx[e >> 1] = fmaxf(mx[e >> 1], x);
                }
            float alpha[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r]);
                alpha[r] = expf(m[r] - m_new);
                m[r] = m_new;
                l[r] *= alpha[r];
            }
#pragma unroll
            for (int n = 0; n < NB; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = !MASKED || visible(n, e)
                        ? expf(sc[n][e] - m[e >> 1]) : 0.0f;
                    sc[n][e] = p;
                    l[e >> 1] += p;
                }
            // O = alpha·O, skipped where no row's max moved (alpha = 1
            // exactly: the product would not change a bit)
            if (__any_sync(0xffffffffu,
                           alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    acc[j][0] *= alpha[0];
                    acc[j][1] *= alpha[0];
                    acc[j][2] *= alpha[1];
                    acc[j][3] *= alpha[1];
                }
            }
        };
        if (whole)
            softmax(std::false_type());
        else
            softmax(std::true_type());

        // O += P·V: 8-key step n, P's A fragment straight from the score
        // registers (a0 = c0, a1 = c2, a2 = c1, a3 = c3), split once
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            const float pa[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
            unsigned ph[4], pl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                ph[e] = to_tf32(pa[e]);
                pl[e] = to_tf32(pa[e] - __uint_as_float(ph[e]));
            }
            const int vo = v_at<D>(8 * n + t, dbase / 4 + g);
            // four output accumulators at a time, their chains side by
            // side as in S
#pragma unroll
            for (int jq = 0; jq < NJ / 4; ++jq) {
                unsigned vh[2][4], vl[2][4];   // rows t, t + 4
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int o = vo + 4 * D * r + 32 * jq;
                    load4(Vh + o, vh[r]);
                    load4(sVl + o, vl[r]);
                }
                float d[4][4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    mma_tf32_first(d[jj], ph, vh[0][jj], vh[1][jj]);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    mma_tf32(d[jj], ph, vl[0][jj], vl[1][jj]);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    mma_tf32(d[jj], pl, vh[0][jj], vh[1][jj]);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[4 * jq + jj][e] += d[jj][e];
            }
        }
    }
    cp_async_wait<0>();

    // the quad's partial row sums, then the rows out: lane t holds columns
    // dbase + 32 jq + 8t .. + 7 (accumulators 4 jq .. 4 jq + 3, their
    // columns 2t and 2t + 1) of rows g and g + 8. A chunk of a split sweep
    // writes its O unnormalised with its m and l (the row's m and l by
    // lane t = 0 of the first column warp), for mha_combine_kernel.
    const long long rows = static_cast<long long>(gridDim.y) * Tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int qpos = q0 + 16 * rg + g + 8 * r;
        if (qpos >= Tq) continue;
        const long long row = static_cast<long long>(b * Tq + qpos) * Hq + h;
        float inv = 1.0f / fmaxf(l[r], 1e-30f);
        float* orow = o + row * D + dbase + 8 * t;
        if (splits > 1) {
            const long long prow = blockIdx.z * rows + row;
            if (t == 0 && dbase == 0) {
                float* ml = part + splits * rows * D + 2 * prow;
                ml[0] = m[r];
                ml[1] = l[r];
            }
            inv = 1.0f;
            orow = part + prow * D + dbase + 8 * t;
        }
#pragma unroll
        for (int jq = 0; jq < NJ / 4; ++jq) {
            const int j = 4 * jq;
            *reinterpret_cast<float4*>(orow + 32 * jq) = make_float4(
                acc[j][2 * r] * inv, acc[j + 1][2 * r] * inv,
                acc[j + 2][2 * r] * inv, acc[j + 3][2 * r] * inv);
            *reinterpret_cast<float4*>(orow + 32 * jq + 4) = make_float4(
                acc[j][2 * r + 1] * inv, acc[j + 1][2 * r + 1] * inv,
                acc[j + 2][2 * r + 1] * inv, acc[j + 3][2 * r + 1] * inv);
        }
    }
}

// The split sweep's combine: each output row from its `splits` chunks in
// chunk order, O = sum_s e_s O_s / max(sum_s e_s l_s, 1e-30) with e_s =
// exp(m_s - max_s m_s) (a chunk that saw no key has m_s = NEG_INF, l_s = 0,
// O_s = 0; a row that saw none in any gives 0, as unsplit). One thread a
// 16-byte chunk of a row; no atomics, so two launches give the same bits.
template <int D>
__global__ void __launch_bounds__(256)
mha_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                   long long rows, int splits) {
    const long long i = static_cast<long long>(blockIdx.x) * 256
        + threadIdx.x;
    if (i >= rows * (D / 4)) return;
    const long long row = i / (D / 4);
    const int c = static_cast<int>(i % (D / 4));
    const float* ml = part + splits * rows * D;
    float mx = NEG_INF;
    for (int s = 0; s < splits; ++s)
        mx = fmaxf(mx, ml[2 * (s * rows + row)]);
    float den = 0.0f;
    float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < splits; ++s) {
        const long long ps = s * rows + row;
        const float e = expf(ml[2 * ps] - mx);
        den += e * ml[2 * ps + 1];
        const float4 x =
            reinterpret_cast<const float4*>(part + ps * D)[c];
        num.x += e * x.x;
        num.y += e * x.y;
        num.z += e * x.z;
        num.w += e * x.w;
    }
    const float inv = 1.0f / fmaxf(den, 1e-30f);
    reinterpret_cast<float4*>(o + row * D)[c] =
        make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv);
}

// One launch of an instantiation (its opt-in to shared memory past 48 KB
// made once per card), then the combine of a split sweep.
template <int D, int BQ, int BK, int STAGES, bool CAP>
int launch_mha(const float* q, const float* k, const float* v, float* o,
               int B, int Tq, int Tk, int Hq, int Hkv, int causal,
               int window, float softcap, float scale, int splits,
               float* part, cudaStream_t stream) {
    using T = AttnTile<D, BQ, BK, STAGES>;
    auto kern = mha_tc_kernel<D, BQ, BK, STAGES, CAP>;
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= kMaxDevices)
        return static_cast<int>(err != cudaSuccess ? err
                                                   : cudaErrorInvalidDevice);
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted_in[dev] = true;
    }
    const dim3 grid((Tq + BQ - 1) / BQ, B * Hq, splits);
    kern<<<grid, T::THREADS, T::SMEM, stream>>>(
        q, k, v, o, Tq, Tk, Hq, Hkv, causal, window, softcap, scale, splits,
        part);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const long long rows = static_cast<long long>(B) * Tq * Hq;
    mha_combine_kernel<D><<<static_cast<unsigned>(
                                (rows * (D / 4) + 255) / 256),
                            256, 0, stream>>>(part, o, rows, splits);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (bq, bk, stages, splits): kernels/attention.py _plan's for the launch;
// (bq, bk, stages) one of the compiled REPRO_ATTN_TILES, any other refused;
// with splits > 1, `part` holds splits x B·Tq·Hq x (D + 2) floats.
extern "C" int repro_mha_f32(const float* q, const float* k, const float* v,
                             float* o, int B, int Tq, int Tk, int Hq, int Hkv,
                             int D, int causal, int window, float softcap,
                             float scale, int bq, int bk, int stages,
                             int splits, float* part, cudaStream_t stream) {
    if (B <= 0 || Tq <= 0) return 0;
    if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535 || splits < 1
        || splits > 65535 || (splits > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_ATTN_TILE(D_, BQ_, BK_, S_)                                  \
    if (D == D_ && bq == BQ_ && bk == BK_ && stages == S_)                 \
        return softcap > 0.0f                                              \
            ? launch_mha<D_, BQ_, BK_, S_, true>(q, k, v, o, B, Tq, Tk, Hq, \
                  Hkv, causal, window, softcap, scale, splits, part,       \
                  stream)                                                  \
            : launch_mha<D_, BQ_, BK_, S_, false>(q, k, v, o, B, Tq, Tk,   \
                  Hq, Hkv, causal, window, softcap, scale, splits, part,   \
                  stream);
    REPRO_ATTN_TILES
#undef REPRO_ATTN_TILE
    return static_cast<int>(cudaErrorInvalidValue);
}
