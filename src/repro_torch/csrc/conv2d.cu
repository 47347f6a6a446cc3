// SAME-padded NHWC convolution with the fused epilogue act(conv + b) + res,
// on the TF32 tensor cores at fp32 accuracy.
//
// Replaces the two Pallas bodies of src/repro/kernels/conv2d.py `conv2d`:
//   * repro_conv2d_nhwc_f32        <- the grid kernel (`_conv_kernel` :52,
//     `_conv_strip` :73, pallas_call :229), which sweeps halo'd row strips
//     of a pre-padded copy of the image through K^2 shifted MXU matmuls (#1);
//   * repro_conv2d_nhwc_f32_double <- `conv2d(pipeline="double")`
//     (`_conv_dma_kernel` :91, pallas_call :198), the same strips DMA'd
//     into the second of two VMEM slots while the MXU contracts the first
//     (#2).
//
// Both are one implicit GEMM: out (M = N*Ho*Wo pixels, F filters) =
// A (M, K*K*C) x W (K*K*C, F), where A's rows are the pixel windows read
// straight from the unpadded input (taps outside the image read 0, with the
// asymmetric SAME split pad_top = pad_h / 2) and W is the HWIO filter as it
// lies in memory, reduction index k = (kh * K + kw) * C + c. No padded copy
// of x and no im2col buffer.
//
// Arithmetic. TF32 keeps 11 significant bits. Both operands are split
// into two TF32 values, both rounded to nearest (cvt.rna): hi = tf32(v)
// and lo = tf32(v - hi), where v - hi is exact in f32 and |v - hi| <=
// 2^-11 |v|, so |v - hi - lo| <= 2^-11 |v - hi| <= 2^-22 |v| (rounding lo
// as well, as CUTLASS's 3xTF32 does, halves what the MMA's truncation of
// an unrounded lo would cost). Each product is three m16n8k8 TF32 MMAs,
// a_hi·w_hi + a_hi·w_lo + a_lo·w_hi, every partial product exact in the
// f32 accumulator. What a product loses is a_hi (w - w_hi - w_lo) +
// (a - a_hi - a_lo) w_hi + the dropped a·w's lo·lo part, each <= 2^-22
// |a·w| to first order: at most 3·2^-22 |a·w| (7.2e-7), against fp32's
// 2^-24 (6e-8) for one rounding; so over K·K·C terms the result is within
// about 3·2^-22 sum |a·w| plus f32 rounding of the sums, not fp32's own
// bound. The tensor cores add with truncation, not rounding, so no chain
// of MMAs carries the large terms: each step's a_hi·w_hi MMA (8 products)
// starts from zero and is added to the running sum by an f32 add on the
// CUDA cores; the slice's 8 cross-term MMAs, 2^-11 of the sum, share one
// fresh accumulator, added last. So the sum carries f32 rounding, K·K·C /
// 8 + K·K·C / 32 adds, as the fp32-FMA kernel it replaced did (K·K·C
// FMAs), not a truncation bias that grows with K. No --use_fast_math;
// the epilogue is apply_act in f32.
//
// Tile. A 256-thread block owns a BM x BN output tile of a work item (m
// tile, n tile, K chunk), BN sized to F from one table (kernels/conv2d.py
// CONV_TILES, written into conv_tiles.h at build time; _plan picks the
// tile whose columns exceed F by at most 25% where F >= 16). Its eight
// warps split the rows, 16 a warp (one m16 tile; 32 in the 256-row tile),
// and the 64-row tile's columns in two; a warp owns FN n8 tiles of
// columns. Each A fragment serves FN MMAs; the whole tile's B fragments
// are read by every warp along the rows. mma.sync m16n8k8 fragments,
// whose layout the PTX ISA fixes: lane (g = lane / 4, t = lane % 4) holds A
// at rows g, g + 8 and columns t, t + 4; B at rows t, t + 4 and column g; C
// at rows g, g + 8 and columns 2t, 2t + 1. Within a slice of 32 features,
// step s (0..3) contracts features 8t + 2s (column t of A, row t of B) and
// 8t + 2s + 1 (column t + 4): a sum does not care about its order, so lane
// t reads features 8t..8t+7 of its rows, two 16-byte loads a row a slice,
// of A stored [pixel][k] and of W stored transposed [filter][k] (rows of 36
// floats: the 16-byte loads of a quarter warp's rows fall in distinct bank
// groups). W is split once a slice, as it is stored into that transposed
// pair (w_hi, w_lo); A is split as each fragment is loaded.
//
// Staging. A slice's A rows are gathered from x in place: where C % 4 == 0
// (every conv but the stem), the four features of a 16-byte copy lie in one
// tap; else (the stem's C = 3, whose K*K*C = 27 fits one slice) a copy is 4
// bytes. A thread keeps one column of a slice, so the tap of its feature,
// (kh, kw, c) and its offset in x, is split once a slice; each row's window
// (its offset in x and its top-left ih0, iw0) is computed once an item into
// a table in shared memory. Rows past M, taps outside the image and
// features past K*K*C read 0. W rows are copied 16 bytes along F where F %
// 4 == 0, else element by element; filters past F read 0.
//
// Blocks are persistent: the grid is what the card holds at once
// (CV_RESIDENT blocks an SM), each block walking items blockIdx.x,
// blockIdx.x + gridDim.x, ... whose slices form one stream, so the next
// item's first slice loads under this item's last MMAs. Where the tiles
// number fewer than CV_RESIDENT x the SMs, K*K*C is split into chunks of
// whole slices: each chunk writes its f32 partial sums to a scratch
// (splits, M, F) and a second kernel adds them in split order and applies
// the epilogue (no atomics: two launches give the same bits).
//
// #1 and #2 are one template. #1 loads slice s + 1 (windows and W) into
// registers before slice s's MMAs and stores it, W split on the way, into
// the other of two buffers after them. #2 is the TPU kernel's DMA double
// buffer: as that kernel DMAs the image strips and keeps the filter as a
// block input, #2 copies the windows by cp.async into as many stages as its
// share of shared memory holds, all but one in flight ahead of the slice
// contracted, and brings W in as #1 does (W has to be split before the MMAs
// read it; a raw W stage and a split pass of its own cost a second barrier
// a slice). One barrier a slice in both. Same tile, plan, reduction order,
// split pass and epilogue, so #2 equals #1 bit for bit.
//
// Bound on this card, by this route: max(bytes / 3.35 TB/s, 3·2·M·KKC·F /
// 495 TFLOP/s dense TF32) (x, w, b, res read once, y written once; which of
// the two is larger varies by case, and chip_smoke.py prints it). The
// kernels run at several times it: mma.sync, not wgmma, keeps the TF32 peak
// out of reach, and the gather's addressing, the splits and the f32 adds
// cost CUDA-core instructions in every slice that the MMAs do not hide.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
// REPRO_CONV_BK and REPRO_CONV_TILES: written into the build by
// kernels/_build.py from kernels/conv2d.py (_CONV_BK, CONV_TILES), the one
// place the table is kept.
#include "conv_tiles.h"

namespace {

constexpr int CV_THREADS = 256;
constexpr int CV_BK = REPRO_CONV_BK;       // features a slice
static_assert(CV_BK == 32, "a slice is 4 lanes t x 8 features (above)");
// blocks an SM (__launch_bounds__; kernels/conv2d.py _RESIDENT plans the
// split to the same grid) and each one's share of the SM's 228 KB, less
// the 1 KB the card reserves for a block
constexpr int CV_RESIDENT = 2;
constexpr int CV_SHARE = 228 * 1024 / CV_RESIDENT - 1024;
constexpr int CV_LD = CV_BK + 4;           // an A row, a transposed W column
// an ih0 (row past M) or kh (feature past K*K*C) that fails every bounds
// test; |ih0| < 2^15 so that it packs into 16 bits
constexpr int CV_FAR = -16384;

template <int TBM, int TBN>
struct ConvTile {
    static constexpr int WM = TBM / 16 < 8 ? TBM / 16 : 8;  // warps along M
    static constexpr int WN = 8 / WM;                 // warps along N
    static constexpr int WTM = TBM / WM;              // a warp's rows
    static constexpr int WTN = TBN / WN;              // a warp's columns
    static constexpr int FM = WTM / 16;               // m16 tiles a warp
    static constexpr int FN = WTN / 8;                // n8 tiles a warp
    static constexpr int A_FLOATS = TBM * CV_LD;      // A [TBM][CV_LD]
    static constexpr int BT_FLOATS = TBN * CV_LD;     // w_hi or w_lo [TBN][CV_LD]
    static constexpr int W_UNITS = CV_BK * TBN / 4;   // 4-filter copies a slice
    static constexpr int W_CPT = (W_UNITS + CV_THREADS - 1) / CV_THREADS;
    static constexpr int ROWS_BYTES = 2 * TBM * 8;    // two items' windows
    // two buffers of w_hi, w_lo (both kernels); #1: two of A, #2: STAGES
    static constexpr int W_BUFS = 2 * 2 * BT_FLOATS;
    static constexpr int REG_SMEM = (2 * A_FLOATS + W_BUFS) * 4 + ROWS_BYTES;
    static constexpr int STAGES =
        (CV_SHARE - W_BUFS * 4 - ROWS_BYTES) / (A_FLOATS * 4);
    static constexpr int DBL_SMEM =
        (STAGES * A_FLOATS + W_BUFS) * 4 + ROWS_BYTES;
    static_assert(WM * WN == 8 && TBM == WM * WTM && TBN == WN * WTN
                  && WTM % 16 == 0 && WTN % 8 == 0, "warp grid");
    static_assert(TBM <= CV_THREADS, "a thread a row of the window table");
    static_assert(STAGES >= 2 && REG_SMEM <= CV_SHARE,
                  "CV_RESIDENT blocks an SM");
};

struct ConvArgs {
    const float* x;
    const float* w;
    const float* b;
    const float* res;
    float* y;
    float* part;      // splits > 1: (splits, M, F) partial sums
    int H, W, C, K, F, stride, Ho, Wo, pad_top, pad_left, act;
    int M, KKC;
    int wvec;         // W copied 16 bytes at a time (F % 4 == 0, aligned)
    int ovec;         // y, res and part 8 bytes at a time (F even, aligned)
};

// The tap of one feature: its offset in x from a window's origin, and
// (kh, kw); kh = CV_FAR past K*K*C.
struct Tap {
    int off, kh, kw;
};

__device__ __forceinline__ Tap tap_of(const ConvArgs& a, int k) {
    if (k >= a.KKC) return {0, CV_FAR, 0};
    const int tp = k / a.C;
    const int c = k - tp * a.C;
    const int kh = tp / a.K;
    const int kw = tp - kh * a.K;
    return {(kh * a.W + kw) * a.C + c, kh, kw};
}

// Row r's window (a table entry: its origin's offset in x, and ih0 << 16
// | iw0 & 0xFFFF) at a tap: the source in x, or nullptr outside the image.
__device__ __forceinline__ const float* tap_src(const ConvArgs& a, int2 row,
                                                const Tap& tp) {
    const int ih = (row.y >> 16) + tp.kh;
    const int iw = (static_cast<int>(static_cast<unsigned>(row.y) << 16)
                    >> 16) + tp.kw;
    return static_cast<unsigned>(ih) < static_cast<unsigned>(a.H)
                   && static_cast<unsigned>(iw) < static_cast<unsigned>(a.W)
               ? a.x + row.x + tp.off
               : nullptr;
}

// W copy u of a slice -> its feature row (0..31) and its 4-filter column:
// a warp's 32 copies are 16 feature rows x 2 columns, so that the global
// loads take whole 32-byte sectors and the transposed stores (column
// 4·fc + e, row k: banks 16·fc + 4e + k mod 32) hit 32 distinct banks.
__device__ __forceinline__ int w_row(int u) { return (u & 15) | ((u >> 1) & 16); }
__device__ __forceinline__ int w_col(int u) { return ((u >> 4) & 1) | ((u >> 5) & ~1); }

// Four filters 4·fc.. of feature row kr, split into the transposed pair:
// the one place W is split, for both kernels, so both hold the same bits.
__device__ __forceinline__ void store_split(float4 v, float* Bh, float* Bl,
                                            int kr, int fc) {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float hi = __uint_as_float(to_tf32(e[j]));
        Bh[(4 * fc + j) * CV_LD + kr] = hi;
        Bl[(4 * fc + j) * CV_LD + kr] = __uint_as_float(to_tf32(e[j] - hi));
    }
}

// A position in a block's stream of slices: its item, the slice within
// it, and the item's tile and K chunk; `fresh` until the item's window
// table is written.
struct Cursor {
    int item, s, m0, n0, kt0, nt;
    bool fresh;
};

template <int TBM, int TBN, bool X16, bool DOUBLE>
__global__ void __launch_bounds__(CV_THREADS, CV_RESIDENT)
conv2d_tc_kernel(const ConvArgs a, int splits) {
    using T = ConvTile<TBM, TBN>;
    constexpr int FM = T::FM, FN = T::FN;
    constexpr int A_BUFS = DOUBLE ? T::STAGES : 2;
    extern __shared__ __align__(128) float cv_smem[];
    // [A_BUFS][A], then [2][w_hi, w_lo], then the window tables of two
    // items
    float* const Wb = cv_smem + A_BUFS * T::A_FLOATS;
    int2* const rows = reinterpret_cast<int2*>(Wb + T::W_BUFS);

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (tid / 32) / T::WN;
    const int wn = (tid / 32) % T::WN;
    const int m_tiles = (a.M + TBM - 1) / TBM;
    const int n_tiles = (a.F + TBN - 1) / TBN;
    const int items = m_tiles * n_tiles * splits;
    const int k_tiles = (a.KKC + CV_BK - 1) / CV_BK;
    const int per = (k_tiles + splits - 1) / splits;

    // item -> its tile and K chunk (m fastest, then n, then the split);
    // returns its slices
    auto item_tiles = [&](int it, int& m0, int& n0, int& kt0) -> int {
        m0 = (it % m_tiles) * TBM;
        n0 = (it / m_tiles % n_tiles) * TBN;
        kt0 = it / (m_tiles * n_tiles) * per;
        return max(min(k_tiles, kt0 + per) - kt0, 0);
    };
    auto seek = [&](Cursor& c) {      // first item from c.item with slices
        for (; c.item < items; c.item += gridDim.x) {
            c.nt = item_tiles(c.item, c.m0, c.n0, c.kt0);
            if (c.nt > 0) break;
        }
        c.fresh = true;
    };
    auto advance = [&](Cursor& c) {   // past the slice just brought in
        if (++c.s == c.nt) {
            c.s = 0;
            c.item += gridDim.x;
            seek(c);
        }
    };

    // The windows' producer (A), and W's: one cursor in #1, which brings
    // both in one slice ahead; in #2 A runs STAGES - 1 slices ahead and W
    // one.
    Cursor pa{static_cast<int>(blockIdx.x), 0, 0, 0, 0, 0, true};
    seek(pa);
    Cursor pw = pa;
    int a_slot = 0, tab = 1;
    // pa's item's window table, written at its first slice into the other
    // of two tables: a thread still reading the previous item's is at most
    // one item behind (a barrier lies between)
    auto window_table = [&]() -> const int2* {
        if (pa.fresh) {
            pa.fresh = false;
            tab ^= 1;
            const int hw = a.Ho * a.Wo;
            for (int r = tid; r < TBM; r += CV_THREADS) {
                const int m = pa.m0 + r;
                int off = 0, ih0 = CV_FAR, iw0 = 0;
                if (m < a.M) {
                    const int n = m / hw;
                    const int rem = m - n * hw;
                    const int oh = rem / a.Wo;
                    ih0 = oh * a.stride - a.pad_top;
                    iw0 = (rem - oh * a.Wo) * a.stride - a.pad_left;
                    off = ((n * a.H + ih0) * a.W + iw0) * a.C;
                }
                rows[tab * TBM + r] = make_int2(
                    off, static_cast<int>((static_cast<unsigned>(ih0) << 16)
                                          | (static_cast<unsigned>(iw0)
                                             & 0xFFFFu)));
            }
            __syncthreads();
        }
        return rows + tab * TBM;
    };

    // A's copies: a thread keeps column kc of rows r0, r0 + RSTEP, ...
    constexpr int A_PER_ROW = X16 ? CV_BK / 4 : CV_BK;
    constexpr int RSTEP = CV_THREADS / A_PER_ROW;
    constexpr int A_CPT = TBM / RSTEP;
    const int r0 = tid / A_PER_ROW;
    const int kc = (X16 ? 4 : 1) * (tid % A_PER_ROW);

    // #2: issue pa's slice's window copies into stage a_slot, then close
    // the group (an empty one past the block's last slice)
    auto produce_a = [&]() {
        if (pa.item < items) {
            const int2* R = window_table();
            const Tap tp = tap_of(a, (pa.kt0 + pa.s) * CV_BK + kc);
            float* As = cv_smem + a_slot * T::A_FLOATS;
#pragma unroll
            for (int i = 0; i < A_CPT; ++i) {
                const int r = r0 + RSTEP * i;
                const float* src = tap_src(a, R[r], tp);
                if constexpr (X16)
                    cp_async16(As + r * CV_LD + kc, src ? src : a.x,
                               src != nullptr);
                else
                    cp_async4(As + r * CV_LD + kc, src ? src : a.x,
                              src != nullptr);
            }
            advance(pa);
        }
        a_slot = a_slot + 1 == T::STAGES ? 0 : a_slot + 1;
        cp_async_commit();
    };

    // #1: pa's slice's windows into registers (fetch_a), then into an A
    // buffer (put_a); both kernels: pw's slice of W into registers
    // (fetch_w), then split into a w_hi, w_lo buffer (put_w)
    constexpr int XV = DOUBLE ? 1 : A_CPT;
    float4 xv[X16 ? XV : 1];
    float xs[X16 ? 1 : XV];
    float4 wv[T::W_CPT];
    auto fetch_a = [&]() {
        if constexpr (!DOUBLE) {
            const int2* R = window_table();
            const Tap tp = tap_of(a, (pa.kt0 + pa.s) * CV_BK + kc);
#pragma unroll
            for (int i = 0; i < A_CPT; ++i) {
                const float* src = tap_src(a, R[r0 + RSTEP * i], tp);
                if constexpr (X16)
                    xv[i] = src ? __ldg(reinterpret_cast<const float4*>(src))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                else
                    xs[i] = src ? __ldg(src) : 0.0f;
            }
            advance(pa);
        }
    };
    auto put_a = [&](int buf) {
        if constexpr (!DOUBLE) {
            float* As = cv_smem + buf * T::A_FLOATS;
#pragma unroll
            for (int i = 0; i < A_CPT; ++i) {
                const int r = r0 + RSTEP * i;
                if constexpr (X16)
                    *reinterpret_cast<float4*>(As + r * CV_LD + kc) = xv[i];
                else
                    As[r * CV_LD + kc] = xs[i];
            }
        }
    };
    auto fetch_w = [&](Cursor& c) {
        const int k0 = (c.kt0 + c.s) * CV_BK;
#pragma unroll
        for (int i = 0; i < T::W_CPT; ++i) {
            const int u = tid + i * CV_THREADS;
            if (u >= T::W_UNITS) break;
            const int k = k0 + w_row(u), f = c.n0 + 4 * w_col(u);
            const float* src = a.w + static_cast<size_t>(k) * a.F + f;
            if (a.wvec) {
                wv[i] = k < a.KKC && f < a.F
                    ? __ldg(reinterpret_cast<const float4*>(src))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else {
                float e[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    e[j] = k < a.KKC && f + j < a.F ? __ldg(src + j) : 0.0f;
                wv[i] = make_float4(e[0], e[1], e[2], e[3]);
            }
        }
        advance(c);
    };
    auto put_w = [&](int buf) {
        float* Bh = Wb + buf * 2 * T::BT_FLOATS;
#pragma unroll
        for (int i = 0; i < T::W_CPT; ++i) {
            const int u = tid + i * CV_THREADS;
            if (u >= T::W_UNITS) break;
            store_split(wv[i], Bh, Bh + T::BT_FLOATS, w_row(u), w_col(u));
        }
    };

    float acc[FM][FN][4];
    // one staged slice into acc: lane t's features 8t..8t+7. Each m16 tile
    // i splits its A fragments of the slice's four steps once (a0..a3 of
    // step s: (g, k), (g + 8, k), (g, k + 1), (g + 8, k + 1), k = 8t + 2s);
    // for each (i, j), every step's a_hi·w_hi MMA starts from zero (dh)
    // and is added to acc in f32, and the slice's 8 cross-term MMAs sum
    // into one fresh dl, added last
    auto contract = [&](const float* As, const float* Bh, const float* Bl) {
        const float* Ap = As + (wm * T::WTM + g) * CV_LD + 8 * t;
        const int bo = (wn * T::WTN + g) * CV_LD + 8 * t;
#pragma unroll
        for (int i = 0; i < FM; ++i) {
            unsigned ahi[4][4], alo[4][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const float4 u0 = *reinterpret_cast<const float4*>(
                    Ap + 16 * i * CV_LD + 4 * half);
                const float4 u1 = *reinterpret_cast<const float4*>(
                    Ap + (16 * i + 8) * CV_LD + 4 * half);
#pragma unroll
                for (int ss = 0; ss < 2; ++ss) {
                    const float v[4] = {ss ? u0.z : u0.x, ss ? u1.z : u1.x,
                                        ss ? u0.w : u0.y, ss ? u1.w : u1.y};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        ahi[2 * half + ss][q] = to_tf32(v[q]);
                        alo[2 * half + ss][q] = to_tf32(
                            v[q] - __uint_as_float(ahi[2 * half + ss][q]));
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < FN; ++j) {
                float dl[4];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const float4 bh = *reinterpret_cast<const float4*>(
                        Bh + bo + 8 * j * CV_LD + 4 * half);
                    const float4 bl = *reinterpret_cast<const float4*>(
                        Bl + bo + 8 * j * CV_LD + 4 * half);
#pragma unroll
                    for (int ss = 0; ss < 2; ++ss) {
                        const int st = 2 * half + ss;
                        const unsigned h0 = __float_as_uint(ss ? bh.z : bh.x);
                        const unsigned h1 = __float_as_uint(ss ? bh.w : bh.y);
                        const unsigned l0 = __float_as_uint(ss ? bl.z : bl.x);
                        const unsigned l1 = __float_as_uint(ss ? bl.w : bl.y);
                        float dh[4];
                        mma_tf32_first(dh, ahi[st], h0, h1);
                        if (st == 0)
                            mma_tf32_first(dl, ahi[st], l0, l1);
                        else
                            mma_tf32(dl, ahi[st], l0, l1);
                        mma_tf32(dl, alo[st], h0, h1);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[i][j][e] += dh[e];
                    }
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += dl[e];
            }
        }
    };

    // epilogue from registers: lane t holds columns 2t, 2t + 1 of each n8
    // tile j, rows g and g + 8 of each m16 tile; the activation a
    // constant (dispatched once an item)
    auto epilogue_as = [&](int it, int m0, int n0, auto act_c) {
        constexpr int ACT = decltype(act_c)::value;
        const int split = it / (m_tiles * n_tiles);
        const int nb = n0 + wn * T::WTN + 2 * t;
        // the columns' bias, loaded before any store (y might alias b, as
        // far as the compiler knows)
        float bias[FN][2];
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int n = nb + 8 * j + c;
                bias[j][c] = splits == 1 && n < a.F ? a.b[n] : 0.0f;
            }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm * T::WTM + 16 * i + 8 * h + g;
                if (m >= a.M) continue;
                const size_t row = static_cast<size_t>(m) * a.F;
#pragma unroll
                for (int j = 0; j < FN; ++j) {
                    const int n = nb + 8 * j;
                    if (n >= a.F) continue;
                    const bool two = n + 1 < a.F;
                    float o[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
                    float* dst;
                    if (splits > 1) {
                        dst = a.part + static_cast<size_t>(split) * a.M * a.F
                            + row + n;
                    } else {
                        dst = a.y + row + n;
                        // act(acc + b), then + res: the order of the TPU
                        // kernel's epilogue (and of the split pass)
                        o[0] = apply_act(o[0] + bias[j][0], ACT);
                        o[1] = apply_act(o[1] + bias[j][1], ACT);
                        if (a.res != nullptr) {
                            const float* rs = a.res + row + n;
                            if (a.ovec) {
                                const float2 r2 =
                                    *reinterpret_cast<const float2*>(rs);
                                o[0] += r2.x;
                                o[1] += r2.y;
                            } else {
                                o[0] += rs[0];
                                if (two) o[1] += rs[1];
                            }
                        }
                    }
                    if (a.ovec) {
                        *reinterpret_cast<float2*>(dst) =
                            make_float2(o[0], o[1]);
                    } else {
                        dst[0] = o[0];
                        if (two) dst[1] = o[1];
                    }
                }
            }
    };
    auto epilogue = [&](int it, int m0, int n0) {
        using std::integral_constant;
        switch (a.act) {
        case ACT_HARDSWISH:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_HARDSWISH>());
            break;
        case ACT_LEAKY_RELU:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_LEAKY_RELU>());
            break;
        case ACT_SILU:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_SILU>());
            break;
        case ACT_RELU:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_RELU>());
            break;
        case ACT_GELU:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_GELU>());
            break;
        default:
            epilogue_as(it, m0, n0, integral_constant<int, ACT_IDENTITY>());
        }
    };

    // The block's slices form one stream across its items. #1 loads slice
    // s + 1 (windows and W) into registers under slice s's MMAs and stores
    // it into the other buffers after them. #2 keeps STAGES - 1 slices of
    // windows in flight by cp.async (the TPU kernel's DMA'd strips) and
    // brings W in as #1 does. One barrier a slice: it publishes slice s's
    // buffers and frees those slice s - 1 was read from.
    int wbuf = 0;                     // slice s's w_hi, w_lo and, #1, A
    if constexpr (DOUBLE) {
#pragma unroll 1
        for (int s = 0; s + 1 < T::STAGES; ++s) produce_a();
    } else if (pa.item < items) {
        fetch_a();
        put_a(0);
    }
    if (pw.item < items) {
        fetch_w(pw);
        put_w(0);
    }
    int slot = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int m0, n0, kt0;
        const int n_t = item_tiles(it, m0, n0, kt0);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        for (int s = 0; s < n_t; ++s) {
            if constexpr (DOUBLE) cp_async_wait<T::STAGES - 2>();
            __syncthreads();
            const float* Bh = Wb + wbuf * 2 * T::BT_FLOATS;
            const bool more = pw.item < items;
            if constexpr (DOUBLE) {
                produce_a();                  // into the stage read last
                if (more) fetch_w(pw);        // loads in flight under the
                contract(cv_smem + slot * T::A_FLOATS, Bh,  // MMAs
                         Bh + T::BT_FLOATS);
                slot = slot + 1 == T::STAGES ? 0 : slot + 1;
            } else {
                if (more) {
                    fetch_a();
                    fetch_w(pw);
                }
                contract(cv_smem + wbuf * T::A_FLOATS, Bh,
                         Bh + T::BT_FLOATS);
                if (more) put_a(wbuf ^ 1);
            }
            if (more) put_w(wbuf ^ 1);
            wbuf ^= 1;
        }
        epilogue(it, m0, n0);
    }
    if constexpr (DOUBLE) cp_async_wait<0>();
}

// The split-K pass: each output adds its `splits` partial sums in split
// order, then the epilogue. No atomics: two launches on the same inputs
// give the same bits.
__global__ void __launch_bounds__(CV_THREADS)
conv2d_split_reduce_kernel(const ConvArgs a, int splits) {
    const size_t mf = static_cast<size_t>(a.M) * a.F;
    const size_t i = static_cast<size_t>(blockIdx.x) * CV_THREADS
        + threadIdx.x;
    if (i >= mf) return;
    float acc = a.part[i];
    for (int s = 1; s < splits; ++s) acc += a.part[s * mf + i];
    float v = apply_act(acc + a.b[i % a.F], a.act);
    if (a.res != nullptr) v += a.res[i];
    a.y[i] = v;
}

// One launch of an instantiation: a persistent grid of the blocks the card
// holds at once, CV_RESIDENT an SM (the SM count and the opt-in to shared
// memory past 48 KB read once per device).
template <int TBM, int TBN, bool X16, bool DOUBLE>
cudaError_t launch_conv_tile(const ConvArgs& a, int splits,
                             cudaStream_t stream) {
    using T = ConvTile<TBM, TBN>;
    constexpr int SMEM = DOUBLE ? T::DBL_SMEM : T::REG_SMEM;
    constexpr int MAX_DEVICES = 16;
    static int sms[MAX_DEVICES] = {};
    auto kern = conv2d_tc_kernel<TBM, TBN, X16, DOUBLE>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int n_sm = dev < MAX_DEVICES ? sms[dev] : 0;
    if (n_sm == 0) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e != cudaSuccess) return e;
        if (dev < MAX_DEVICES) sms[dev] = n_sm;
    }
    const long long items = static_cast<long long>((a.M + TBM - 1) / TBM)
        * ((a.F + TBN - 1) / TBN) * splits;
    if (items <= 0 || items >= (1LL << 31)) return cudaErrorInvalidValue;
    const long long slots = static_cast<long long>(CV_RESIDENT) * n_sm;
    kern<<<static_cast<unsigned>(items < slots ? items : slots), CV_THREADS,
           SMEM, stream>>>(a, splits);
    return cudaGetLastError();
}

// The compiled (BM, BN) table, REPRO_CONV_TILES; kernels/conv2d.py _plan
// picks from it.
template <bool X16, bool DOUBLE>
cudaError_t launch_conv_table(const ConvArgs& a, int bm, int bn, int splits,
                              cudaStream_t s) {
#define REPRO_CONV_TILE(BM_, BN_)                                         \
    if (bm == BM_ && bn == BN_)                                           \
        return launch_conv_tile<BM_, BN_, X16, DOUBLE>(a, splits, s);
    REPRO_CONV_TILES
#undef REPRO_CONV_TILE
    return cudaErrorInvalidValue;
}

// #1 (DOUBLE false) or #2: the tile, then the split reduce.
template <bool DOUBLE>
int launch_conv(const float* x, const float* w, const float* b,
                const float* res, float* y, int N, int H, int W, int C, int K,
                int F, int stride, int Ho, int Wo, int pad_top, int pad_left,
                int act, int bm, int bn, int splits, float* ws,
                cudaStream_t stream) {
    // windows pack ih0, iw0 into 16 bits each
    if (splits < 1 || (splits > 1 && ws == nullptr) || b == nullptr
        || H >= 32768 || W >= 32768 || pad_top > K || pad_left > K)
        return static_cast<int>(cudaErrorInvalidValue);
    auto aligned = [](const void* p, int bytes) {
        return reinterpret_cast<uintptr_t>(p) % bytes == 0;
    };
    const ConvArgs a{x, w, b, res, y, splits > 1 ? ws : nullptr, H, W, C, K,
                     F, stride, Ho, Wo, pad_top, pad_left, act, N * Ho * Wo,
                     K * K * C, F % 4 == 0 && aligned(w, 16),
                     F % 2 == 0 && aligned(y, 8)
                         && (res == nullptr || aligned(res, 8))
                         && (splits == 1 || aligned(ws, 8))};
    const bool x16 = C % 4 == 0 && aligned(x, 16);
    const cudaError_t e =
        x16 ? launch_conv_table<true, DOUBLE>(a, bm, bn, splits, stream)
            : launch_conv_table<false, DOUBLE>(a, bm, bn, splits, stream);
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long mf = static_cast<long long>(a.M) * F;
    conv2d_split_reduce_kernel<<<
        static_cast<unsigned>((mf + CV_THREADS - 1) / CV_THREADS),
        CV_THREADS, 0, stream>>>(a, splits);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_conv2d_nhwc_f32(
        const float* x, const float* w, const float* b, const float* res,
        float* y, int N, int H, int W, int C, int K, int F, int stride,
        int Ho, int Wo, int pad_top, int pad_left, int act, int bm, int bn,
        int splits, float* ws, cudaStream_t stream) {
    return launch_conv<false>(x, w, b, res, y, N, H, W, C, K, F, stride, Ho,
                              Wo, pad_top, pad_left, act, bm, bn, splits, ws,
                              stream);
}

extern "C" int repro_conv2d_nhwc_f32_double(
        const float* x, const float* w, const float* b, const float* res,
        float* y, int N, int H, int W, int C, int K, int F, int stride,
        int Ho, int Wo, int pad_top, int pad_left, int act, int bm, int bn,
        int splits, float* ws, cudaStream_t stream) {
    return launch_conv<true>(x, w, b, res, y, N, H, W, C, K, F, stride, Ho,
                             Wo, pad_top, pad_left, act, bm, bn, splits, ws,
                             stream);
}
