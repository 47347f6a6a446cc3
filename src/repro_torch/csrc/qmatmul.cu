// Quantized matmuls with the dequantization in the epilogue (paper §IV-A).
//
// Replaces the Pallas kernels of src/repro/kernels/qmatmul.py:
//   * repro_qmatmul_f32         <- `qmatmul` (_qmm_kernel, _unpack4): float
//     activations x integer weight codes (int8, int16, or packed int4),
//     f32 accumulator plus the row sum of x, epilogue
//     acc*scale + xsum*(zero*scale) + b -> act -> + res; on the tensor
//     cores at fp32 accuracy (see "#7 on the tensor cores" below);
//   * repro_qmatmul_a8          <- `qmatmul_a8` (_qmm_a8_kernel): int8
//     activation codes x int8 / packed-int4 codes, int32 accumulator and
//     row sum, epilogue with the activation scale folded into the weight
//     scale (scale = wscale * x_scale, zero = wzero * scale); on the int8
//     tensor cores (see "#8, #10");
//   * repro_qmatmul_a8_double   <- `qmatmul_a8(pipeline="double")`
//     (_qmm_a8_dma_kernel): #8 with the K slices of x and of the codes
//     copied into shared-memory stages by cp.async, the TPU kernel's DMA
//     double buffer;
//   * repro_qmatmul_a8_grouped  <- `qmatmul_a8` with a per-K-run activation
//     scale (_qmm_a8_grouped_kernel): the exact int32 sum of each K block
//     of `tk` features, and of its row sums, scaled by that block's f32
//     scale into f32 accumulators in block order; epilogue
//     acc*wscale + xsum*(wzero*wscale); on #8's int8 tensor-core tile
//     (see "#9" in that section).
//
// The TPU kernels walk a padded (M, K, N) grid with the K block as the
// sequential grid axis and an accumulator in VMEM scratch. Here a block
// owns an output tile and loops over K itself, staging a K slice of x and
// of the codes in shared memory. Bounds are predicated (rows >= M,
// columns >= N and features >= K read as code or value 0), so no padded
// copy of x, the codes or res is made. Packed int4 codes are unpacked
// while staging: byte r holds feature 2r in its low nibble and 2r+1 in
// its high nibble, sign-extended by arithmetic shifts (the last high
// nibble is padding when K is odd). Scale and zero are per tensor
// (stride 0) or per column (stride 1).
//
// #8, #9 and #10 run on the int8 tensor cores (mma.sync m16n8k32, int32
// sums) with tiles sized to N and a split of K, one tile template and
// epilogue for the three (their section); #9 adds f32 accumulators that
// take each K block's int32 sums times the block's scale.
//
// #7 on the tensor cores. TF32 keeps 11 significant bits, and every int8
// or int4 code (|code| <= 128) is exact in it. Each x value is split into
// hi = tf32(x) (round to nearest) and lo = x - hi, exact in f32; the MMA
// reads lo's top 19 bits (a TF32 operand's low 13 bits are ignored:
// truncation), so |x - hi - lo_tf32| <= 2^-11 · 2^-10 · |x| = 2^-21 |x|.
// The product is two TF32 MMAs, x_hi·codes + x_lo·codes, each term exact
// and accumulated in f32. The tensor cores add with truncation, not
// rounding, so each stage (or, in the (128, 64) tile, which has no
// registers to spare, each 8-feature step) sums its products into a
// fresh accumulator that is then added to the running sum by f32 adds on
// the CUDA cores: the result carries f32 rounding, as the SIMT kernel it
// replaced did, not TF32's, nor a truncation bias that grows with K.
// int16 codes are not exact in TF32; they are split as code = 256·h + l
// with h = code >> 8 in [-128, 127] and l = code & 255 in [0, 255], both
// exact (and 256·h too, a power of two times an exact value), so int16
// takes four MMAs into the same accumulator. rowsum(x) is summed in f32
// on the CUDA cores from the staged, unsplit x values. The MMAs are
// mma.sync m16n8k8 TF32 with their fragments built by hand (see #7's
// section), not WMMA: WMMA's fragments hide their layout, which costs a
// 4-byte shared load per MMA, a float copy of the codes, a second
// barrier a stage and an epilogue through shared memory.
//
// Tiles are sized to N from a fixed table of four (BM, BN) per code kind
// (kernels/qmatmul.py TILES and _plan): (256, 16), (128, 32), (128, 64) for large
// M, so that the computed columns exceed N by at most 25% where N >= 16,
// and (16, 128) for M <= 64 (a decode step). Blocks are persistent: the
// grid is what the card holds at once (two blocks an SM), and each block
// walks work items (m tile, n tile, K chunk) as one stream of 32-feature
// stages, so that the next item's copies overlap this item's last stages
// and its epilogue: short K (the stem's one stage an item) pipelines
// too, and no shape ends on a part-filled wave. Where the tiles number
// fewer than 2 x 132, K is split into chunks of whole stages: each
// chunk writes its partial sums to an f32 scratch (splits, M, N) and its
// partial row sums to (splits, M), and a second kernel sums them in
// split order and applies the epilogue (no atomics, so the result is
// deterministic). Staging is three to eight stages deep (deeper where a
// stage is small): x and the raw codes by cp.async (x 16 bytes a copy
// where K % 4 == 0, else 4; codes 16 bytes along N, or element by
// element where N or the pointer forbids it), zero-filled past each
// edge; the codes are unpacked and converted to float as each B
// fragment is built. The epilogue runs from registers, 16-byte stores
// where N % 4 == 0.
//
// Bound on this card, by the route the card's best kernel would take:
// max(bytes / 3.35 TB/s, passes·2MKN / 495 TFLOP/s dense TF32), passes 2
// (4 for int16). At yolov8n's shapes that is bytes (the stem, the 3x3
// convs at 160, the 1x1s) or the TF32 passes (3x3 at 80 and below); at a
// decode step (M = 4) it is the codes' bytes. mma.sync, not wgmma, keeps
// the TF32 peak out of reach; the hi/lo split and the int8 -> float
// conversion cost CUDA-core instructions in every stage.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
// #7's plan table, REPRO_QMM_BK and REPRO_QMM_TILES: written into the
// build by kernels/_build.py from kernels/qmatmul.py (_BK, TILES), the one
// place the table is kept.
#include "qmm_tiles.h"

namespace {

enum CodeKind : int { CODES_INT8 = 0, CODES_INT16 = 1, CODES_PACKED4 = 2 };

// ---------------------------------------------------------------- #7
// The tensor-core tile of the float x integer-codes product (the note at
// the top of the file gives the arithmetic). A 256-thread block owns a
// BM x BN output tile of a work item; its eight warps each own a
// (BM / WM) x (BN / WN) piece as FM x FN m16n8 accumulators of the
// mma.sync m16n8k8 TF32 instruction, whose fragment layouts are fixed by
// the PTX ISA: lane (g = lane / 4, t = lane % 4) holds A at rows g and
// g + 8, columns t and t + 4; B at rows t and t + 4, column g; C at rows
// g and g + 8, columns 2t and 2t + 1.
//
// Two permutations, free because a sum does not care about its order and
// an output column is wherever the epilogue writes it, make every lane's
// operands contiguous in shared memory:
//   * K, within a stage of TC_BK = 32 features: step s (0..3) contracts
//     features 8t + 2s (column t of A, row t of B) and 8t + 2s + 1
//     (column t + 4, row t + 4), so lane t reads features 8t .. 8t + 7
//     of x, two 16-byte loads a row a stage, and the same features of
//     the codes;
//   * N, within a warp's columns: accumulator j's column c is the
//     warp's column FN·c + j, so lane g reads FN adjacent codes of a
//     feature row in one load, and lane t ends with the 2·FN adjacent
//     output columns 2·FN·t .. of its rows, stored 16 bytes at a time.
// rowsum(x) comes from the same x values on the CUDA cores before they
// are split (f32 adds, the four lanes of a row's quad combined at the
// end of an item), and B fragments are built from the raw code bytes in
// shared memory: no float copy of the codes and one barrier a stage.
constexpr int TC_THREADS = 256;
constexpr int TC_BK = REPRO_QMM_BK;    // features a stage
static_assert(TC_BK == 32, "a stage is 4 lanes t x 8 features (above)");
// blocks of every tile an SM holds at once: __launch_bounds__ and
// TcTile's shared memory keep each tile to it (kernels/qmatmul.py
// _RESIDENT sizes the split of K to the same grid)
constexpr int TC_RESIDENT = 2;

// The layout of one (KIND, BM, BN) instantiation.
template <int KIND, int TBM, int TBN>
struct TcTile {
    static constexpr int WN = TBN == 16 ? 1 : (TBN == 128 ? 8 : 2);
    static constexpr int WM = 8 / WN;                 // warps along M
    static constexpr int WTM = TBM / WM;              // a warp's rows
    static constexpr int WTN = TBN / WN;              // a warp's columns
    static constexpr int FM = WTM / 16;               // m16 tiles a warp
    static constexpr int FN = WTN / 8;                // n8 tiles a warp
    // int16 codes are two planes, 256·(code >> 8) and code & 255
    static constexpr int PLANES = KIND == CODES_INT16 ? 2 : 1;
    static constexpr int ESIZE = KIND == CODES_INT16 ? 2 : 1;
    // stages in flight: deep where a stage is small (a decode step's
    // codes); three where a fourth would cost a block's residency
    static constexpr int STAGES = TBM == 16 ? 8 : (TBM == 256 ? 3 : 4);
    // x tile row: 36 floats, so that the 16-byte loads of the eight rows
    // g of a quarter warp fall in distinct bank groups
    static constexpr int LDA = TC_BK + 4;
    static constexpr int A_STAGE = TBM * LDA;         // floats
    static constexpr int CHUNK_COLS = 16 / ESIZE;     // columns a copy
    static constexpr int QROWS = KIND == CODES_PACKED4 ? TC_BK / 2 : TC_BK;
    static constexpr int QROW_BYTES = TBN * ESIZE;
    static constexpr int RAW_STAGE = QROWS * QROW_BYTES;   // bytes
    static constexpr int CHUNKS_ROW = TBN / CHUNK_COLS;
    static constexpr int CHUNKS = QROWS * CHUNKS_ROW;
    static constexpr int CPT = (CHUNKS + TC_THREADS - 1) / TC_THREADS;
    static constexpr int RAW_OFF = 4 * STAGES * A_STAGE;   // bytes
    static constexpr int SMEM_BYTES = RAW_OFF + STAGES * RAW_STAGE;
    static_assert(WM * WN == 8 && FM >= 1 && (FN == 2 || FN == 4),
                  "warp grid");
    // an SM's 228 KB hold two blocks of 113 KB and their 1 KB reserve
    static_assert(TC_RESIDENT == 2 && SMEM_BYTES <= 113 * 1024,
                  "TC_RESIDENT blocks an SM");
};

struct QmmArgs {
    const float* x;
    const void* q;
    const float* scale;
    int scale_stride;
    const float* zero;
    int zero_stride;
    const float* b;
    const float* res;
    float* y;
    float* part;      // splits > 1: (splits, M, N) sums, then (splits, M)
    int M, K, N, act;
    int qvec;         // codes copied 16 bytes at a time
    int ovec;         // y, res and part written and read 16 bytes at a time
};

// One output: acc·sc + xsum·(zero·sc) + b -> act -> + res, the order of
// the SIMT kernel this one replaced and of the TPU kernel's epilogue.
__device__ __forceinline__ float qmm_output(const QmmArgs& a, float acc,
                                            float xsum, int m, int n) {
    const float sc = a.scale[n * a.scale_stride];
    const float zs = a.zero[n * a.zero_stride] * sc;
    float v = acc * sc + xsum * zs;
    if (a.b != nullptr) v += a.b[n];
    v = apply_act(v, a.act);
    if (a.res != nullptr) v += a.res[m * a.N + n];
    return v;
}

// 16 bytes of code row `kr` (of `rows`) from column n, element by element
// (the copy where N or the pointer rules out a 16-byte one); zero past
// either edge.
template <int ESIZE, int COLS>
__device__ __forceinline__ uint4 load_chunk(const int8_t* __restrict__ qb,
                                            int kr, int rows, int n,
                                            int N) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (kr < rows) {
        const int8_t* row = qb + static_cast<size_t>(kr) * N * ESIZE;
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
            if (n + e < N) {
                const unsigned bits = ESIZE == 2
                    ? static_cast<unsigned>(static_cast<uint16_t>(
                          reinterpret_cast<const int16_t*>(row)[n + e]))
                    : static_cast<unsigned>(static_cast<uint8_t>(row[n + e]));
                w[(e * ESIZE) / 4] |= bits << (8 * ((e * ESIZE) % 4));
            }
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Signed byte i, low nibble i, high nibble i and short h of a word, by
// shifts (arithmetic right shifts sign-extend).
__device__ __forceinline__ float code_s8(unsigned w, int i) {
    return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}
__device__ __forceinline__ float code_lo4(unsigned w, int i) {
    return static_cast<float>(static_cast<int>(w << (28 - 8 * i)) >> 28);
}
__device__ __forceinline__ float code_hi4(unsigned w, int i) {
    return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 28);
}
__device__ __forceinline__ int code_s16(unsigned w, int h) {
    return static_cast<int>(w << (16 - 16 * h)) >> 16;
}

// The B values of one step: features k and k + 1 (h = 0, 1) of the FN
// adjacent columns at `col` of a stage's raw codes, as floats (exact in
// TF32), per plane.
template <int KIND, int FN, int QROW_BYTES>
__device__ __forceinline__ void load_b(const int8_t* Rt, int k, int col,
                                       float (&bv)[KIND == CODES_INT16 ? 2
                                                   : 1][2][FN]) {
    if constexpr (KIND == CODES_PACKED4) {
        // features k, k + 1 (k even) are the nibbles of byte row k / 2
        const int8_t* p = Rt + (k / 2) * QROW_BYTES + col;
        const unsigned w = FN == 4
            ? *reinterpret_cast<const unsigned*>(p)
            : *reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int j = 0; j < FN; ++j) {
            bv[0][0][j] = code_lo4(w, j);
            bv[0][1][j] = code_hi4(w, j);
        }
    } else if constexpr (KIND == CODES_INT8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int8_t* p = Rt + (k + h) * QROW_BYTES + col;
            const unsigned w = FN == 4
                ? *reinterpret_cast<const unsigned*>(p)
                : *reinterpret_cast<const unsigned short*>(p);
#pragma unroll
            for (int j = 0; j < FN; ++j) bv[0][h][j] = code_s8(w, j);
        }
    } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int8_t* p = Rt + (k + h) * QROW_BYTES + 2 * col;
            unsigned w[2];
            if constexpr (FN == 4) {
                const uint2 v = *reinterpret_cast<const uint2*>(p);
                w[0] = v.x;
                w[1] = v.y;
            } else {
                w[0] = *reinterpret_cast<const unsigned*>(p);
                w[1] = 0u;
            }
#pragma unroll
            for (int j = 0; j < FN; ++j) {
                const int c = code_s16(w[j / 2], j % 2);
                bv[0][h][j] = 256.0f * static_cast<float>(c >> 8);
                bv[1][h][j] = static_cast<float>(c & 255);
            }
        }
    }
}

// A persistent block: it walks the work items (m tile, n tile, K chunk)
// blockIdx.x, blockIdx.x + gridDim.x, ... and its stages, one K slice
// of TC_BK features each, form one stream across items, so the copies
// of the next item's first stages overlap this item's last ones and its
// epilogue (what short-K shapes, one or two stages an item, need).
template <int KIND, int TBM, int TBN, bool X16>
__global__ void __launch_bounds__(TC_THREADS, TC_RESIDENT)
qmatmul_tc_kernel(const QmmArgs a, int splits) {
    using T = TcTile<KIND, TBM, TBN>;
    constexpr int FM = T::FM, FN = T::FN;
    extern __shared__ __align__(128) float tc_smem[];
    float* As = tc_smem;                      // [STAGES][TBM][LDA]
    int8_t* raw = reinterpret_cast<int8_t*>(tc_smem) + T::RAW_OFF;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (tid / 32) / T::WN;
    const int wn = (tid / 32) % T::WN;
    const int8_t* qb = static_cast<const int8_t*>(a.q);
    const int qrows = KIND == CODES_PACKED4 ? (a.K + 1) / 2 : a.K;
    const int m_tiles = (a.M + TBM - 1) / TBM;
    const int n_tiles = (a.N + TBN - 1) / TBN;
    const int items = m_tiles * n_tiles * splits;
    const int k_tiles = (a.K + TC_BK - 1) / TC_BK;
    const int per = (k_tiles + splits - 1) / splits;

    // item -> its tile and K chunk: m fastest, then n, then the split
    auto item_tiles = [&](int it, int& m0, int& n0, int& kt0) -> int {
        m0 = (it % m_tiles) * TBM;
        n0 = (it / m_tiles % n_tiles) * TBN;
        kt0 = it / (m_tiles * n_tiles) * per;
        return max(min(k_tiles, kt0 + per) - kt0, 0);
    };

    // the producer: the next stage to copy, across items
    int p_item = blockIdx.x, p_t = 0, p_slot = 0;
    int p_m0 = 0, p_n0 = 0, p_kt0 = 0, p_nt = 0;
    auto p_seek = [&]() {             // first item from p_item with stages
        for (; p_item < items; p_item += gridDim.x) {
            p_nt = item_tiles(p_item, p_m0, p_n0, p_kt0);
            if (p_nt > 0) break;
        }
    };
    // copy the next stage into its slot (x by cp.async; the codes 16 bytes
    // a copy where they allow it, else loaded element by element and
    // stored), then close the group, an empty one past the last stage
    auto produce = [&]() {
        if (p_item < items) {
            const int k0 = (p_kt0 + p_t) * TC_BK;
            float* At = As + p_slot * T::A_STAGE;
            // a thread copies one column (of 4 floats, or 1) of rows
            // r0, r0 + RSTEP, ...: its source steps by RSTEP rows
            constexpr int PER_ROW = X16 ? TC_BK / 4 : TC_BK;
            constexpr int RSTEP = TC_THREADS / PER_ROW;
            const int r0 = tid / PER_ROW;
            const int kc = (X16 ? 4 : 1) * (tid % PER_ROW);
            const bool kin = k0 + kc < a.K;
            const float* src =
                a.x + static_cast<size_t>(p_m0 + r0) * a.K + k0 + kc;
            const size_t step = static_cast<size_t>(RSTEP) * a.K;
#pragma unroll 8
            for (int r = r0; r < TBM; r += RSTEP, src += step) {
                const bool in = kin && p_m0 + r < a.M;
                if constexpr (X16)
                    cp_async16(At + r * T::LDA + kc, in ? src : a.x, in);
                else
                    cp_async4(At + r * T::LDA + kc, in ? src : a.x, in);
            }
            const int kr0 = KIND == CODES_PACKED4 ? k0 / 2 : k0;
            int8_t* Rt = raw + p_slot * T::RAW_STAGE;
#pragma unroll
            for (int i = 0; i < T::CPT; ++i) {
                const int c = tid + i * TC_THREADS;
                if (c >= T::CHUNKS) break;
                const int r = c / T::CHUNKS_ROW, j = c % T::CHUNKS_ROW;
                const int kr = kr0 + r, n = p_n0 + j * T::CHUNK_COLS;
                int8_t* dst = Rt + r * T::QROW_BYTES + 16 * j;
                if (a.qvec) {
                    const bool in = kr < qrows && n < a.N;
                    cp_async16(dst, in ? qb + (static_cast<size_t>(kr) * a.N
                                               + n) * T::ESIZE : qb, in);
                } else {
                    *reinterpret_cast<uint4*>(dst) =
                        load_chunk<T::ESIZE, T::CHUNK_COLS>(qb, kr, qrows,
                                                            n, a.N);
                }
            }
            if (++p_t == p_nt) {
                p_t = 0;
                p_item += gridDim.x;
                p_seek();
            }
        }
        p_slot = p_slot + 1 == T::STAGES ? 0 : p_slot + 1;
        cp_async_commit();
    };

    p_seek();
#pragma unroll
    for (int s = 0; s + 1 < T::STAGES; ++s) produce();

    int slot = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int m0, n0, kt0;
        const int n_t = item_tiles(it, m0, n0, kt0);
        float acc[FM][FN][4];
        float xs[FM][2];                  // this lane's part of a row sum
#pragma unroll
        for (int i = 0; i < FM; ++i) {
            xs[i][0] = xs[i][1] = 0.0f;
#pragma unroll
            for (int j = 0; j < FN; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        }
        for (int st = 0; st < n_t; ++st) {
            cp_async_wait<T::STAGES - 2>();   // this stage landed (thread)
            __syncthreads();                  // ... every thread's; and the
            produce();                        // slot read last is free
            const float* At = As + slot * T::A_STAGE
                + (wm * T::WTM + g) * T::LDA + 8 * t;
            const int8_t* Rt = raw + slot * T::RAW_STAGE;
            const int col = wn * T::WTN + FN * g;
            slot = slot + 1 == T::STAGES ? 0 : slot + 1;
            // the tensor cores add in f32 with truncation, so their chains
            // stay short: tiles with room for it sum a stage's products
            // in a fresh accumulator, the (128, 64) tile a step's; either
            // is added to the running sum by f32 adds on the CUDA cores
            constexpr bool STAGE_ACC = FM * FN <= 4;
            float part[STAGE_ACC ? FM : 1][STAGE_ACC ? FN : 1][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                // steps 2·half and 2·half + 1: this lane's features
                // 8t + 4·half .. + 3, one 16-byte load a row
                float bv[2][T::PLANES][2][FN];
#pragma unroll
                for (int ss = 0; ss < 2; ++ss)
                    load_b<KIND, FN, T::QROW_BYTES>(
                        Rt, 8 * t + 4 * half + 2 * ss, col, bv[ss]);
#pragma unroll
                for (int i = 0; i < FM; ++i) {
                    const float4 r0 = *reinterpret_cast<const float4*>(
                        At + 16 * i * T::LDA + 4 * half);
                    const float4 r1 = *reinterpret_cast<const float4*>(
                        At + (16 * i + 8) * T::LDA + 4 * half);
                    xs[i][0] += r0.x;
                    xs[i][0] += r0.y;
                    xs[i][0] += r0.z;
                    xs[i][0] += r0.w;
                    xs[i][1] += r1.x;
                    xs[i][1] += r1.y;
                    xs[i][1] += r1.z;
                    xs[i][1] += r1.w;
#pragma unroll
                    for (int ss = 0; ss < 2; ++ss) {
                        // a0..a3: (g, k), (g + 8, k), (g, k + 1),
                        // (g + 8, k + 1)
                        const float v[4] = {ss ? r0.z : r0.x,
                                            ss ? r1.z : r1.x,
                                            ss ? r0.w : r0.y,
                                            ss ? r1.w : r1.y};
                        // lo is the exact remainder; the MMA reads its top
                        // 19 bits (TF32), truncating it
                        unsigned ahi[4], alo[4];
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            ahi[q] = to_tf32(v[q]);
                            alo[q] = __float_as_uint(
                                v[q] - __uint_as_float(ahi[q]));
                        }
#pragma unroll
                        for (int j = 0; j < FN; ++j) {
                            float d[4];
                            float (&sum)[4] =
                                STAGE_ACC ? part[STAGE_ACC ? i : 0]
                                                [STAGE_ACC ? j : 0] : d;
                            const bool first = !STAGE_ACC
                                || (half == 0 && ss == 0);
#pragma unroll
                            for (int p = 0; p < T::PLANES; ++p) {
                                // codes and their int16 planes are exact
                                const unsigned b0 =
                                    __float_as_uint(bv[ss][p][0][j]);
                                const unsigned b1 =
                                    __float_as_uint(bv[ss][p][1][j]);
                                if (first && p == 0)
                                    mma_tf32_first(sum, ahi, b0, b1);
                                else
                                    mma_tf32(sum, ahi, b0, b1);
                                mma_tf32(sum, alo, b0, b1);
                            }
                            if (!STAGE_ACC) {
#pragma unroll
                                for (int e = 0; e < 4; ++e)
                                    acc[i][j][e] += d[e];
                            }
                        }
                    }
                }
            }
            if (STAGE_ACC) {
#pragma unroll
                for (int i = 0; i < FM; ++i)
#pragma unroll
                    for (int j = 0; j < FN; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[i][j][e] += part[STAGE_ACC ? i : 0]
                                                [STAGE_ACC ? j : 0][e];
            }
        }

        // epilogue from registers: lane t owns output columns
        // nb .. nb + 2·FN - 1 of rows g and g + 8 of each m16 tile, the
        // column o being accumulator j = o % FN, element 2·rr + o / FN
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                xs[i][rr] += __shfl_xor_sync(0xffffffffu, xs[i][rr], 1);
                xs[i][rr] += __shfl_xor_sync(0xffffffffu, xs[i][rr], 2);
            }
        const int nb = n0 + wn * T::WTN + 2 * FN * t;
        const int split = it / (m_tiles * n_tiles);
        float sc[2 * FN], zs[2 * FN], bb[2 * FN];
        if (splits == 1) {
#pragma unroll
            for (int o = 0; o < 2 * FN; ++o) {
                const int n = nb + o;
                const bool in = n < a.N;
                sc[o] = in ? a.scale[n * a.scale_stride] : 0.0f;
                zs[o] = in ? a.zero[n * a.zero_stride] * sc[o] : 0.0f;
                bb[o] = in && a.b != nullptr ? a.b[n] : 0.0f;
            }
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int m = m0 + wm * T::WTM + 16 * i + 8 * rr + g;
                if (m >= a.M) continue;
                float v[2 * FN];
#pragma unroll
                for (int o = 0; o < 2 * FN; ++o)
                    v[o] = acc[i][o % FN][2 * rr + o / FN];
                float* dst;
                if (splits > 1) {
                    dst = a.part + (static_cast<size_t>(split) * a.M + m)
                        * a.N;
                    if (wn == 0 && t == 0 && n0 == 0)
                        a.part[static_cast<size_t>(splits) * a.M * a.N
                               + static_cast<size_t>(split) * a.M + m] =
                            xs[i][rr];
                } else {
                    dst = a.y + static_cast<size_t>(m) * a.N;
                    const float* rrow = a.res != nullptr
                        ? a.res + static_cast<size_t>(m) * a.N : nullptr;
#pragma unroll
                    for (int o = 0; o < 2 * FN; ++o) {
                        float u = v[o] * sc[o] + xs[i][rr] * zs[o];
                        if (a.b != nullptr) u += bb[o];
                        v[o] = apply_act(u, a.act);
                    }
                    if (rrow != nullptr) {
                        if (a.ovec) {
#pragma unroll
                            for (int o = 0; o < 2 * FN; o += 4) {
                                if (nb + o >= a.N) break;
                                const float4 r4 =
                                    *reinterpret_cast<const float4*>(
                                        rrow + nb + o);
                                v[o] += r4.x;
                                v[o + 1] += r4.y;
                                v[o + 2] += r4.z;
                                v[o + 3] += r4.w;
                            }
                        } else {
#pragma unroll
                            for (int o = 0; o < 2 * FN; ++o)
                                if (nb + o < a.N) v[o] += rrow[nb + o];
                        }
                    }
                }
                if (a.ovec) {
#pragma unroll
                    for (int o = 0; o < 2 * FN; o += 4)
                        if (nb + o < a.N)
                            *reinterpret_cast<float4*>(dst + nb + o) =
                                make_float4(v[o], v[o + 1], v[o + 2],
                                            v[o + 3]);
                } else {
#pragma unroll
                    for (int o = 0; o < 2 * FN; ++o)
                        if (nb + o < a.N) dst[nb + o] = v[o];
                }
            }
    }
    cp_async_wait<0>();
}

// The split-K pass: each output sums its `splits` partials (and its row's
// partial row sums) in split order, then the epilogue. No atomics: two
// launches on the same inputs give the same bits.
__global__ void __launch_bounds__(TC_THREADS)
qmatmul_split_reduce_kernel(const QmmArgs a, int splits) {
    const size_t mn = static_cast<size_t>(a.M) * a.N;
    const size_t i = static_cast<size_t>(blockIdx.x) * TC_THREADS
        + threadIdx.x;
    if (i >= mn) return;
    const int m = static_cast<int>(i / a.N);
    const int n = static_cast<int>(i % a.N);
    const float* xs = a.part + splits * mn;
    float acc = a.part[i];
    float xsum = xs[m];
    for (int s = 1; s < splits; ++s) {
        acc += a.part[s * mn + i];
        xsum += xs[static_cast<size_t>(s) * a.M + m];
    }
    a.y[i] = qmm_output(a, acc, xsum, m, n);
}

// One launch of an instantiation. The persistent grid is the blocks the
// device holds at once, TC_RESIDENT x its SMs (the count kernels/qmatmul.py
// reads to plan the split), looked up once per device with the opt-in to
// shared memory past 48 KB (`sms`, the instantiation's own).
template <int KIND, int TBM, int TBN, bool X16>
cudaError_t launch_tile(const QmmArgs& a, int splits, cudaStream_t stream) {
    using T = TcTile<KIND, TBM, TBN>;
    constexpr int MAX_DEVICES = 16;
    static int sms[MAX_DEVICES] = {};
    auto kern = qmatmul_tc_kernel<KIND, TBM, TBN, X16>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int n_sm = dev < MAX_DEVICES ? sms[dev] : 0;
    if (n_sm == 0) {
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e != cudaSuccess) return e;
        if (dev < MAX_DEVICES) sms[dev] = n_sm;
    }
    const long long items = static_cast<long long>((a.M + TBM - 1) / TBM)
        * ((a.N + TBN - 1) / TBN) * splits;
    if (items <= 0 || items >= (1LL << 31)) return cudaErrorInvalidValue;
    const long long slots = static_cast<long long>(TC_RESIDENT) * n_sm;
    const int grid = static_cast<int>(items < slots ? items : slots);
    kern<<<grid, TC_THREADS, T::SMEM_BYTES, stream>>>(a, splits);
    return cudaGetLastError();
}

// The compiled (BM, BN) table, REPRO_QMM_TILES; kernels/qmatmul.py _plan
// picks from it.
template <int KIND>
cudaError_t launch_tc(const QmmArgs& a, int bm, int bn, bool x16,
                      int splits, cudaStream_t s) {
#define REPRO_TILE(BM_, BN_)                                              \
    if (bm == BM_ && bn == BN_)                                           \
        return x16 ? launch_tile<KIND, BM_, BN_, true>(a, splits, s)      \
                   : launch_tile<KIND, BM_, BN_, false>(a, splits, s);
    REPRO_QMM_TILES
#undef REPRO_TILE
    return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- #8, #10, #9
// The int8 x int8 product on the tensor cores, one tile for the three
// kernels.
// A 256-thread block owns a BM x BN output tile (kernels/qmatmul.py
// A8_TILES, _plan_a8: BN a multiple of 16 sized to N, split K where the
// tiles are too few to fill the card) and loops over its K chunk in
// slices of A8_BK = 64 features: two k32 steps of
// mma.sync.m16n8k32.s32.s8.s8.s32, whose fragments the PTX ISA fixes:
// lane (g = lane / 4, t = lane % 4) holds A at rows g and g + 8, columns
// 4t..4t+3 and 16+4t..; B at rows (features) 4t..4t+3 and 16+4t.. of
// column g; C at rows g and g + 8, columns 2t and 2t + 1. Integer sums
// are exact in any order, so the int32 accumulator equals the plain int64
// contraction bit for bit, across any split of K.
//
// N in groups of 16 columns, two n8 tiles each: tile j's column c is the
// group's column 2c + j, so a lane's C holds columns 4t..4t+3 of its
// rows, one float4 store a row and group. A warp owns FM m16 tiles x G
// groups; the warps of a block split the rows, and the columns in two
// where a tile has four groups or more. The codes arrive row-major
// (K, N), as the caller gives them (packed int4: byte row r holds
// features 2r and 2r + 1); once a slice, the block transposes them into
// Bt, each column's 64 features contiguous (a8_transpose_b: 4 x 4 byte
// blocks, nibbles unpacked first), so a B register is one 32-bit load.
// Building B in every warp instead (four 16-bit loads and four byte
// permutations a register pair, repeated by each warp that shares the
// columns) made the kernels issue-bound: a tile twice as wide at the
// same bytes took twice the time.
//
// Shared memory banks. A's 32-bit loads read rows g = 0..7 at lane t's
// byte 4t: x rows 80 bytes apart (20 words) start in distinct 4-bank
// groups; B's read columns 2g at byte 4t: Bt columns 72 bytes apart (18
// words) do the same.
//
// x where it lies. The kernels take xq as the caller gives it, at any K
// and any byte offset: no padded copy. With K % 16 == 0 and x 16-byte
// aligned, a slice of a row is four aligned 16-byte copies. Otherwise a
// row's slice is copied as the 16-byte blocks that hold it (at most five,
// into a 112-byte row) and read from its own byte offset, which is the
// same in every slice (k0 % 16 == 0): two aligned 32-bit loads and a
// funnel shift make each A register. Where K <= 64 (the stem's 27) the
// tile's BM rows are BM·K contiguous bytes and are copied as one range
// and read at r·K + k. A block that holds bytes outside x (its first or
// last) is assembled byte by byte. Features past K read whatever a stage
// holds there: each B register is masked to zero past K, so the bytes
// never count.
//
// The row sum of x is one more MMA a step, of the A fragments against a
// tile of ones (masked past K): exact int32, in C's layout, so each lane
// holds the sums of its own rows. The epilogue is the fold of
// qmatmul.py:382-383 (a8_output): sc = wscale·x_scale, zs = wzero·sc,
// acc·sc + xsum·zs + b -> act -> + res, float4 stores and res loads where
// N % 4 == 0 and the pointers allow. A split chunk writes its int32 sums
// and row sums to a scratch (splits, M, N) + (splits, M), and a second
// kernel sums them and applies the epilogue once.
//
// #8 and #10 are this kernel with another way for a slice to reach shared
// memory: #10 (the TPU kernel's DMA double buffer) by 16-byte cp.async
// into as many stages as a block's share of shared memory holds (3 to
// A8_MAX_STAGES), all but one in flight ahead of the slice contracted;
// #8 through registers, the 16-byte global loads of slice s + 1 issued
// before slice s's MMAs and stored to the other of two buffers after
// them. The two give the same bits.
//
// Blocks are persistent: a block's slices form one stream across its
// work items (m tile, n tile, K chunk), so the next item's first slices
// load under this item's last MMAs and its epilogue. Where every item
// has the same one slice of codes (K <= 64 and one column tile: the
// stem, the 1x1 convs), they are copied and transposed once a block.
//
// Bound on this card: bytes (x once, the codes, y and res once) against
// 3.35 TB/s at every yolov8n shape; the int8 tensor-core peak (1979 TOPS)
// is two orders of magnitude away. The kernels run at 2.5-3x that bound
// on the large shapes (chip_smoke.py --a8, H100): an output-heavy shape
// is held back by the epilogue's per-output arithmetic (hardswish's IEEE
// division; the activation is a constant in the epilogue, a runtime
// switch an output cost the stem a third of its time), a K-heavy one by
// the two barriers a slice.
//
// #9 (per-K-block activation scales, SCALES != A8_TENSOR) is this tile
// with a second set of accumulators: the TPU kernel's acc += s_b·dot_b
// over blocks of tk features (any tk >= 8 that divides K; 16 on the
// per-group path, 27 at its stem, 9 for runs of 9). Each k32 step is cut
// at the block boundaries inside it into segments; a segment's MMAs read
// A with the bytes outside it masked to zero (lane t's registers hold
// features 4t..4t+3 and 16+4t..), so one MMA set a segment: one at
// tk % 32 == 0, up to five at tk = 9. tk = 16 has its own instantiation
// (A8_BLOCKS16): a step is two whole blocks, the A registers' halves,
// contracted and folded in turn, straight-line code. A block's first
// segment starts its MMAs from C = 0x4B400000, the bits of 1.5·2^23, so
// that the int32 result d is a float 1.5·2^23 + sum exactly while
// |sum| < 2^22 (tk < 256 int8 codes, < 4096 packed int4): at the block's
// end d as a float less 1.5·2^23 is the exact sum, one FADD where a
// conversion (I2F, a quarter of the FP32 rate) would be, and one FMA by
// s_b adds it to the f32 accumulator, in block order. Larger tk start
// from 0 and convert. The row sums take the same MMA against ones and
// the same fold. The f32 sums beside the int32 ones take registers: #9's
// tiles (kernels/qmatmul.py A8G_TILES) are half #8's, 16 + 16
// accumulators a thread, and its K slices come in by cp.async as #10's
// (#8's staging registers spilled). A split chunk starts at a block
// boundary where the plan can (_plan_a8g: whole lcm(64, tk) feature
// runs) and writes its f32 sums to a scratch that a second kernel adds
// in split order; a chunk that ends inside a block folds it at its end.
// The epilogue is #8's with x_scale 1: acc·wscale + xsum·(wzero·wscale).
constexpr int A8_THREADS = 256;
constexpr int A8_BK = REPRO_A8_BK;     // features a slice
static_assert(A8_BK == 64, "a slice is two k32 steps; row strides below");
// blocks an SM (__launch_bounds__; kernels/qmatmul.py _RESIDENT plans
// the split to it), and the shared memory they share; #10 takes as many
// stages (3 to A8_MAX_STAGES) as its share holds
constexpr int A8_RESIDENT = 2;
constexpr int A8_MAX_STAGES = 8;
constexpr int A8_SM_SMEM = 228 * 1024;  // an SM's shared memory, with
constexpr int A8_BLOCK_RESERVE = 1024;  // 1 KB reserved for each block
constexpr int A8_LDBT = 72;             // a transposed code column
// x row strides in a stage (bytes): 64 features and 16 (20 words); a
// copied row's byte offset (< 16), its fifth block and the second word
// of an unaligned read (28 words: also a distinct 4-bank group per row)
constexpr int A8_LDX16 = 80;
constexpr int A8_LDXSPAN = 112;

template <int TBM, int TBN, bool PACKED, bool X16>
struct A8Tile {
    static constexpr int GROUPS = TBN / 16;           // 16-column groups
    // warps along N: two where the groups pair up (four where BM < 64,
    // so that a warp keeps 16 rows)
    static constexpr int WN =
        GROUPS % 2 == 0 && GROUPS >= 4 ? (TBM < 64 ? 4 : 2) : 1;
    static constexpr int WM = 8 / WN;                 // warps along M
    static constexpr int WTM = TBM / WM;              // a warp's rows
    static constexpr int G = GROUPS / WN;             // a warp's groups
    static constexpr int FM = WTM / 16;               // m16 tiles a warp
    static constexpr int FN = 2 * G;                  // n8 tiles a warp
    static constexpr int LDX = X16 ? A8_LDX16 : A8_LDXSPAN;
    static constexpr int QROWS = PACKED ? A8_BK / 2 : A8_BK;
    static constexpr int Q_STAGE = QROWS * TBN;       // raw code rows
    // the slice's codes transposed (a8_transpose_b): column n's 64
    // features at n·A8_LDBT, 72 bytes (18 words: the columns 2g of a B
    // read start in distinct 4-bank groups)
    static constexpr int BT_BYTES = TBN * A8_LDBT;
    // 16-byte copies of a slice: a row of x, a thread; a code row, a thread
    static constexpr int X_CPR = A8_BK / 16 + (X16 ? 0 : 1);
    static constexpr int X_CPT = (TBM * X_CPR + A8_THREADS - 1) / A8_THREADS;
    static constexpr int Q_CPR = GROUPS;
    static constexpr int Q_CPT =
        (QROWS * Q_CPR + A8_THREADS - 1) / A8_THREADS;
    static constexpr int STAGE_MAX = TBM * LDX + Q_STAGE;
    static_assert(TBN % 16 == 0 && GROUPS % WN == 0 && WTM % 16 == 0
                  && TBM == WM * WTM, "warp grid");
    static_assert(A8_RESIDENT * (3 * STAGE_MAX + BT_BYTES
                                 + A8_BLOCK_RESERVE) <= A8_SM_SMEM,
                  "A8_RESIDENT blocks of three stages an SM");
};

struct A8Args {
    const int8_t* x;
    const int8_t* q;
    const float* wscale;
    int scale_stride;
    const float* wzero;
    int zero_stride;
    float x_scale;
    const float* b;
    const float* res;
    float* y;
    int* part;        // splits > 1: (splits, M, N) sums, then (splits, M)
    int M, K, N, act;
    int qvec;         // codes copied 16 bytes at a time
    int ovec;         // y, res and part written and read 16 bytes at a time
    int per;          // slices a K chunk
    // #9: one f32 activation scale a block of tk features; its int32
    // sums folded through 1.5·2^23 (magic) or converted; the split's f32
    // partial sums (splits, M, N) + (splits, M)
    const float* sblk;
    int tk;
    int magic;
    float* fpart;
};

// acc·sc + xsum·zs + bias -> act, its roundings pinned (the product
// xsum·zs, then one fma) so that the tile's epilogue and the split reduce
// give the same bits. The caller loads the column's scale, zero and bias
// (has_b: b is given), once a column. Acc: int (#8, #10) or float (#9).
template <class Acc>
__device__ __forceinline__ float a8_fold(Acc acc, Acc xsum, float sc,
                                         float zs, bool has_b, float bias,
                                         int act) {
    float v = __fmaf_rn(static_cast<float>(acc), sc,
                        __fmul_rn(static_cast<float>(xsum), zs));
    if (has_b) v = __fadd_rn(v, bias);
    return apply_act(v, act);
}

// One output of #8 and #10: the fold of qmatmul.py:382-383 in its order
// (scale = wscale * x_scale, then zero * scale), bias, act, residual; #9's
// with x_scale 1 (scale = wscale).
template <class Acc>
__device__ __forceinline__ float a8_output(const A8Args& a, Acc acc,
                                           Acc xsum, int m, int n) {
    const float sc = a.wscale[n * a.scale_stride] * a.x_scale;
    const float zs = a.wzero[n * a.zero_stride] * sc;
    const float v = a8_fold(acc, xsum, sc, zs, a.b != nullptr,
                            a.b != nullptr ? a.b[n] : 0.0f, a.act);
    return a.res != nullptr
        ? __fadd_rn(v, a.res[static_cast<size_t>(m) * a.N + n]) : v;
}

// Packed int4 bytes -> the signed low and high nibbles, a byte each.
__device__ __forceinline__ unsigned nibbles_lo(unsigned p) {
    return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ unsigned nibbles_hi(unsigned p) {
    return __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// One 16-byte copy of a slice: from `src` (16-byte aligned where
// `whole`) to byte `dst` of its stage, of bytes lo..hi-1 (hi 0: no copy).
struct A8Copy {
    const int8_t* src;
    int dst, lo, hi;
    bool whole;
};

// Bytes lo..hi-1 of the 16 at `src`, zero elsewhere: a block that a
// 16-byte load would take past an operand's edge or off its alignment.
__device__ __forceinline__ uint4 load16_part(const int8_t* src, int lo,
                                             int hi) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
        if (e >= lo && e < hi)
            w[e / 4] |= static_cast<unsigned>(static_cast<uint8_t>(src[e]))
                        << (8 * (e % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ const int8_t* align16(const int8_t* p) {
    return reinterpret_cast<const int8_t*>(
        reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15));
}

// Copy c of the x slice at feature k0 of rows m0.. (see "x where it lies").
template <int TBM, bool X16>
__device__ __forceinline__ A8Copy a8_x_copy(const A8Args& a, int c, int m0,
                                            int k0, bool flat) {
    A8Copy cp{a.x, 0, 0, 0, false};
    if constexpr (X16) {
        const int r = c / (A8_BK / 16), j = c % (A8_BK / 16);
        if (r < TBM && m0 + r < a.M && k0 + 16 * j < a.K) {
            cp.src = a.x + static_cast<size_t>(m0 + r) * a.K + k0 + 16 * j;
            cp.dst = r * A8_LDX16 + 16 * j;
            cp.hi = 16;
            cp.whole = true;
        }
        return cp;
    } else {
        const int8_t* from;           // the first byte wanted
        int need;                     // bytes wanted from there
        if (flat) {                   // the tile's rows, one range
            from = a.x + static_cast<size_t>(m0) * a.K;
            need = min(TBM, a.M - m0) * a.K;
            cp.dst = 16 * c;
        } else {                      // a row's slice, up to five blocks
            const int r = c / (A8_BK / 16 + 1);
            c %= A8_BK / 16 + 1;
            if (r >= TBM || m0 + r >= a.M) return cp;
            from = a.x + static_cast<size_t>(m0 + r) * a.K + k0;
            need = min(A8_BK, a.K - k0);
            cp.dst = r * A8_LDXSPAN + 16 * c;
        }
        const int8_t* blk = align16(from) + 16 * c;
        if (blk >= from + need) return cp;
        const int8_t* end = a.x + static_cast<size_t>(a.M) * a.K;
        cp.src = blk;
        cp.lo = blk < a.x ? static_cast<int>(a.x - blk) : 0;
        cp.hi = end < blk + 16 ? static_cast<int>(end - blk) : 16;
        cp.whole = cp.lo == 0 && cp.hi == 16;
        return cp;
    }
}

// Copy c of the code rows kr0.. (a slice: 64 rows, or 32 packed byte
// rows) at columns n0..: 16 columns a copy, whole where `qvec`.
template <class T>
__device__ __forceinline__ A8Copy a8_q_copy(const A8Args& a, int c, int n0,
                                            int kr0, int qrows) {
    A8Copy cp{a.q, 0, 0, 0, false};
    const int r = c / T::Q_CPR, j = c % T::Q_CPR;
    const int kr = kr0 + r, n = n0 + 16 * j;
    if (r < T::QROWS && kr < qrows && n < a.N) {
        cp.src = a.q + static_cast<size_t>(kr) * a.N + n;
        cp.dst = r * T::Q_CPR * 16 + 16 * j;
        cp.hi = min(16, a.N - n);
        cp.whole = a.qvec != 0;
    }
    return cp;
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

// A slice's raw codes (QROWS rows of TBN bytes: int8, or packed int4
// whose byte row r holds features 2r and 2r + 1) -> Bt, column n's 64
// features at n·A8_LDBT, byte k = feature k: what each warp's B
// registers read with one 32-bit load. Once a slice for the block, so
// that no warp builds B itself. A thread takes 4 features x 4 columns.
template <int TBN, bool PACKED>
__device__ __forceinline__ void a8_transpose_b(const int8_t* raw,
                                               int8_t* bt, int tid) {
    constexpr int CW = TBN / 4;                   // column words a row
#pragma unroll
    for (int w = tid; w < CW * (A8_BK / 4); w += A8_THREADS) {
        const int c = w % CW, kg = w / CW;        // columns 4c.., k 4kg..
        const unsigned* rw = reinterpret_cast<const unsigned*>(raw) + c;
        unsigned r[4];
        if constexpr (PACKED) {
            const unsigned p0 = rw[(2 * kg) * CW];
            const unsigned p1 = rw[(2 * kg + 1) * CW];
            r[0] = nibbles_lo(p0);
            r[1] = nibbles_hi(p0);
            r[2] = nibbles_lo(p1);
            r[3] = nibbles_hi(p1);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e] = rw[(4 * kg + e) * CW];
        }
        unsigned col[4];
        transpose4x4(r[0], r[1], r[2], r[3], col);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<unsigned*>(bt + (4 * c + j) * A8_LDBT
                                         + 4 * kg) = col[j];
    }
}

// Four bytes of x at byte `b` of a stage: aligned where X16, else from
// the two words that hold them.
template <bool X16>
__device__ __forceinline__ unsigned a8_lds_a(const int8_t* X, int b) {
    if constexpr (X16) {
        return *reinterpret_cast<const unsigned*>(X + b);
    } else {
        const unsigned* w = reinterpret_cast<const unsigned*>(X + (b & ~3));
        return __funnelshift_r(w[0], w[1], 8 * (b & 3));
    }
}

// The bytes of a B register whose feature kb + byte lies below K.
__device__ __forceinline__ unsigned a8_kmask(int K, int kb) {
    const int n = K - kb;
    return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// d += a·b on the int8 tensor cores: m16n8k32, int32 accumulator.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b + c, every element of C the value c (#9: a block's first
// segment, from 0 or from 1.5·2^23's bits).
__device__ __forceinline__ void mma_s8_from(int (&d)[4],
                                            const unsigned (&a)[4],
                                            unsigned b0, unsigned b1, int c) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(c));
}

// The bytes j of a 4-byte A register at byte p of a k32 step with
// lo <= p + j < hi: a segment's share of it (#9).
__device__ __forceinline__ unsigned a8_seg_mask(int p, int lo, int hi) {
    auto below = [](int n) {
        return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
    };
    return below(hi - p) & ~below(lo - p);
}

// 1.5·2^23 as bits and as a float: an int32 d = A8G_MAGIC + v with
// |v| < 2^22 is the float 1.5·2^23 + v, exactly.
constexpr int A8G_MAGIC = 0x4B400000;
constexpr float A8G_MAGIC_F = 12582912.0f;

// #9: fold a block's int32 sums d and row sums x (rows g, g + 8: x[i][0],
// x[i][2]) into the f32 sums by the block's scale s. MAGIC: d holds
// 1.5·2^23's bits plus the sum (the MMAs began from them), so the float
// less 1.5·2^23 is the sum, exactly; else d is the sum, converted.
template <bool MAGIC, int FM, int FN>
__device__ __forceinline__ void a8g_fold(float (&facc)[FM][FN][4],
                                         float (&fxs)[FM][2],
                                         const int (&d)[FM][FN][4],
                                         const int (&x)[FM][4], float s) {
    auto value = [](int v) {
        return MAGIC ? __fsub_rn(__int_as_float(v), A8G_MAGIC_F)
                     : __int2float_rn(v);
    };
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
        for (int f = 0; f < FN; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                facc[i][f][e] = __fmaf_rn(value(d[i][f][e]), s,
                                          facc[i][f][e]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
            fxs[i][h] = __fmaf_rn(value(x[i][2 * h]), s, fxs[i][h]);
    }
}

// cp.async.wait_group with a count known only at run time (#10's
// stages less two)
__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<A8_MAX_STAGES - 2>(); break;
    }
}

// The activation scale of an instantiation: one (#8, #10), or one a K
// block of any tk (#9), or of tk = 16 (#9 on the per-group path: a k32
// step is two whole blocks, its A registers' halves).
enum A8Scales : int { A8_TENSOR = 0, A8_BLOCKS = 1, A8_BLOCKS16 = 2 };

template <int TBM, int TBN, bool PACKED, bool X16, bool DOUBLE,
          int SCALES>
__global__ void __launch_bounds__(A8_THREADS, A8_RESIDENT)
qmatmul_a8_tc_kernel(const A8Args a, int splits, int xstage, int stages) {
    using T = A8Tile<TBM, TBN, PACKED, X16>;
    constexpr bool GROUPED = SCALES != A8_TENSOR;
    static_assert(!GROUPED || DOUBLE, "#9 stages its slices by cp.async");
    constexpr int FM = T::FM, FN = T::FN, G = T::G;
    extern __shared__ __align__(128) int8_t a8_smem[];
    int8_t* Xs = a8_smem;                          // [stages][xstage]
    int8_t* Qs = a8_smem + stages * xstage;        // [stages][Q_STAGE]
    int8_t* Bt = Qs + stages * T::Q_STAGE;         // [TBN][A8_LDBT]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (tid / 32) / T::WN;
    const int wn = (tid / 32) % T::WN;
    const int m_tiles = (a.M + TBM - 1) / TBM;
    const int n_tiles = (a.N + TBN - 1) / TBN;
    const int items = m_tiles * n_tiles * splits;
    const int k_tiles = (a.K + A8_BK - 1) / A8_BK;
    const int per = a.per;
    const int qrows = PACKED ? (a.K + 1) / 2 : a.K;
    const bool flat = !X16 && a.K <= A8_BK;
    // one slice of K and one column tile: every item contracts the same
    // codes, so they are copied and transposed once, for the block's
    // first item
    const bool codes_fixed = k_tiles == 1 && n_tiles == 1;

    // item -> its tile and K chunk (m fastest, then n, then the split);
    // returns its slices
    auto item_tiles = [&](int it, int& m0, int& n0, int& kt0) -> int {
        m0 = (it % m_tiles) * TBM;
        n0 = (it / m_tiles % n_tiles) * TBN;
        kt0 = it / (m_tiles * n_tiles) * per;
        return max(min(k_tiles, kt0 + per) - kt0, 0);
    };

    // the producer: the next slice to bring in, across this block's items
    int p_item = blockIdx.x, p_s = 0, p_slot = 0;
    bool p_codes = true;              // the producer's slice copies codes
    int p_m0 = 0, p_n0 = 0, p_kt0 = 0, p_nt = 0;
    auto p_seek = [&]() {             // first item from p_item with slices
        for (; p_item < items; p_item += gridDim.x) {
            p_nt = item_tiles(p_item, p_m0, p_n0, p_kt0);
            if (p_nt > 0) break;
        }
    };
    auto p_next = [&]() {             // past the slice just brought in
        p_codes = !codes_fixed;
        if (++p_s == p_nt) {
            p_s = 0;
            p_item += gridDim.x;
            p_seek();
        }
    };
    // #10: issue the producer's slice's copies into stage `slot` (cp.async
    // where whole, else loaded and stored), then close the group (an empty
    // one past the block's last slice)
    auto produce = [&]() {
        if (p_item < items) {
            const int k0 = (p_kt0 + p_s) * A8_BK;
            int8_t* xd = Xs + p_slot * xstage;
#pragma unroll
            for (int i = 0; i < T::X_CPT; ++i) {
                const A8Copy cp = a8_x_copy<TBM, X16>(
                    a, tid + i * A8_THREADS, p_m0, k0, flat);
                if (cp.whole)
                    cp_async16(xd + cp.dst, cp.src, true);
                else if (cp.hi)
                    *reinterpret_cast<uint4*>(xd + cp.dst) =
                        load16_part(cp.src, cp.lo, cp.hi);
            }
            int8_t* qd = Qs + p_slot * T::Q_STAGE;
#pragma unroll
            for (int i = 0; i < T::Q_CPT; ++i) {
                if (!p_codes) break;
                const A8Copy cp = a8_q_copy<T>(a, tid + i * A8_THREADS, p_n0,
                                               PACKED ? k0 / 2 : k0, qrows);
                if (cp.whole)
                    cp_async16(qd + cp.dst, cp.src, true);
                else if (cp.hi)
                    *reinterpret_cast<uint4*>(qd + cp.dst) =
                        load16_part(cp.src, cp.lo, cp.hi);
            }
            p_next();
        }
        p_slot = p_slot + 1 == stages ? 0 : p_slot + 1;
        cp_async_commit();
    };
    // #8: load the producer's slice into registers (fetch), then store
    // them into a buffer (put)
    uint4 xv[DOUBLE ? 1 : T::X_CPT], qv[DOUBLE ? 1 : T::Q_CPT];
    int xdst[DOUBLE ? 1 : T::X_CPT], qdst[DOUBLE ? 1 : T::Q_CPT];
    auto fetch = [&]() {
        if constexpr (!DOUBLE) {
            const int k0 = (p_kt0 + p_s) * A8_BK;
#pragma unroll
            for (int i = 0; i < T::X_CPT; ++i) {
                const A8Copy cp = a8_x_copy<TBM, X16>(
                    a, tid + i * A8_THREADS, p_m0, k0, flat);
                xdst[i] = cp.hi ? cp.dst : -1;
                if (cp.whole)
                    xv[i] = __ldg(reinterpret_cast<const uint4*>(cp.src));
                else if (cp.hi)
                    xv[i] = load16_part(cp.src, cp.lo, cp.hi);
            }
#pragma unroll
            for (int i = 0; i < T::Q_CPT; ++i) {
                const A8Copy cp = p_codes
                    ? a8_q_copy<T>(a, tid + i * A8_THREADS, p_n0,
                                   PACKED ? k0 / 2 : k0, qrows)
                    : A8Copy{a.q, 0, 0, 0, false};
                qdst[i] = cp.hi ? cp.dst : -1;
                if (cp.whole)
                    qv[i] = __ldg(reinterpret_cast<const uint4*>(cp.src));
                else if (cp.hi)
                    qv[i] = load16_part(cp.src, cp.lo, cp.hi);
            }
            p_next();
        }
    };
    auto put = [&](int slot) {
        if constexpr (!DOUBLE) {
#pragma unroll
            for (int i = 0; i < T::X_CPT; ++i)
                if (xdst[i] >= 0)
                    *reinterpret_cast<uint4*>(Xs + slot * xstage + xdst[i]) =
                        xv[i];
#pragma unroll
            for (int i = 0; i < T::Q_CPT; ++i)
                if (qdst[i] >= 0)
                    *reinterpret_cast<uint4*>(Qs + slot * T::Q_STAGE
                                              + qdst[i]) = qv[i];
        }
    };

    int acc[FM][FN][4];
    int xs[FM][4];                    // row sums: [0] row g, [2] row g + 8
    // #9: the f32 sums over folded blocks, and of the row sums (rows g,
    // g + 8); g_fresh: acc holds no segment since the last fold; the
    // current block and the feature where it ends
    float facc[FM][FN][4];
    float fxs[FM][2];
    bool g_fresh = true;
    int g_blk = 0, g_end = 0;
    int rb[FM][2];                    // this lane's rows' first byte
    // this lane's column 2g of the warp's first group, in Bt
    const int8_t* Bw = Bt + (wn * 16 * G + 2 * g) * A8_LDBT + 4 * t;

    auto contract = [&](int slot, int kt) {
        const int8_t* X = Xs + slot * xstage;
        const int k0 = kt * A8_BK;
#pragma unroll
        for (int ks = 0; ks < A8_BK / 32; ++ks) {
            if (k0 + 32 * ks >= a.K) break;          // a step past K
            const unsigned mk0 = a8_kmask(a.K, k0 + 32 * ks + 4 * t);
            const unsigned mk1 = a8_kmask(a.K, k0 + 32 * ks + 16 + 4 * t);
            // tile f = 2·gi + j is the group's column 2g + j: features
            // 4t.. and 16 + 4t.. of the step, masked past K
            unsigned bf[FN][2];
#pragma unroll
            for (int f = 0; f < FN; ++f) {
                const int8_t* p = Bw + (16 * (f / 2) + f % 2) * A8_LDBT
                    + 32 * ks;
                bf[f][0] = *reinterpret_cast<const unsigned*>(p) & mk0;
                bf[f][1] = *reinterpret_cast<const unsigned*>(p + 16) & mk1;
            }
            const unsigned one0 = 0x01010101u & mk0;
            const unsigned one1 = 0x01010101u & mk1;
#pragma unroll
            for (int i = 0; i < FM; ++i) {
                const int c = 32 * ks + 4 * t;
                const unsigned av[4] = {a8_lds_a<X16>(X, rb[i][0] + c),
                                        a8_lds_a<X16>(X, rb[i][1] + c),
                                        a8_lds_a<X16>(X, rb[i][0] + c + 16),
                                        a8_lds_a<X16>(X, rb[i][1] + c + 16)};
#pragma unroll
                for (int f = 0; f < FN; ++f)
                    mma_s8(acc[i][f], av, bf[f][0], bf[f][1]);
                mma_s8(xs[i], av, one0, one1);
            }
        }
    };

    auto fold = [&](float s) {
        if (a.magic)
            a8g_fold<true>(facc, fxs, acc, xs, s);
        else
            a8g_fold<false>(facc, fxs, acc, xs, s);
    };
    // #9's steps: each k32 step cut into segments at the block boundaries
    // inside it, A masked to the segment, one MMA set a segment; a
    // block's first segment from C = 1.5·2^23's bits (or 0), a block's
    // end folded by its scale
    auto contract_g = [&](int slot, int kt) {
        const int8_t* X = Xs + slot * xstage;
        const int k0 = kt * A8_BK;
        const int c0 = a.magic ? A8G_MAGIC : 0;
#pragma unroll
        for (int ks = 0; ks < A8_BK / 32; ++ks) {
            const int kb = k0 + 32 * ks;
            if (kb >= a.K) break;                   // a step past K
            const int kend = min(kb + 32, a.K);
            // B and the ones unmasked: A is masked to each segment, which
            // ends at K
            unsigned bf[FN][2];
#pragma unroll
            for (int f = 0; f < FN; ++f) {
                const int8_t* p = Bw + (16 * (f / 2) + f % 2) * A8_LDBT
                    + 32 * ks;
                bf[f][0] = *reinterpret_cast<const unsigned*>(p);
                bf[f][1] = *reinterpret_cast<const unsigned*>(p + 16);
            }
            unsigned av[FM][4];
#pragma unroll
            for (int i = 0; i < FM; ++i) {
                const int c = 32 * ks + 4 * t;
                av[i][0] = a8_lds_a<X16>(X, rb[i][0] + c);
                av[i][1] = a8_lds_a<X16>(X, rb[i][1] + c);
                av[i][2] = a8_lds_a<X16>(X, rb[i][0] + c + 16);
                av[i][3] = a8_lds_a<X16>(X, rb[i][1] + c + 16);
            }
            for (int lo = kb; lo < kend;) {
                const int hi = min(g_end, kend);
                const float s = __ldg(a.sblk + g_blk);
                const unsigned m0 = a8_seg_mask(4 * t, lo - kb, hi - kb);
                const unsigned m1 = a8_seg_mask(16 + 4 * t, lo - kb,
                                                hi - kb);
                auto mmas = [&](auto fresh_c) {
#pragma unroll
                    for (int i = 0; i < FM; ++i) {
                        const unsigned am[4] = {av[i][0] & m0, av[i][1] & m0,
                                                av[i][2] & m1, av[i][3] & m1};
#pragma unroll
                        for (int f = 0; f < FN; ++f) {
                            if constexpr (decltype(fresh_c)::value)
                                mma_s8_from(acc[i][f], am, bf[f][0],
                                            bf[f][1], c0);
                            else
                                mma_s8(acc[i][f], am, bf[f][0], bf[f][1]);
                        }
                        if constexpr (decltype(fresh_c)::value)
                            mma_s8_from(xs[i], am, 0x01010101u, 0x01010101u,
                                        c0);
                        else
                            mma_s8(xs[i], am, 0x01010101u, 0x01010101u);
                    }
                };
                if (g_fresh)
                    mmas(std::integral_constant<bool, true>());
                else
                    mmas(std::integral_constant<bool, false>());
                g_fresh = hi == g_end;
                if (g_fresh) {                      // the block ends
                    fold(s);
                    ++g_blk;
                    g_end += a.tk;
                }
                lo = hi;
            }
        }
    };
    // #9 at tk = 16: a step's two blocks are its halves, lane t's A
    // registers 0, 1 (features 4t..) and 2, 3 (16 + 4t..); each half's
    // MMAs start from 1.5·2^23's bits, straight-line code, and the halves
    // fold in order (a half past K, where K % 32 == 16, is not folded)
    auto contract_g16 = [&](int slot, int kt) {
        const int8_t* X = Xs + slot * xstage;
        const int k0 = kt * A8_BK;
#pragma unroll
        for (int ks = 0; ks < A8_BK / 32; ++ks) {
            const int kb = k0 + 32 * ks;
            if (kb >= a.K) break;                   // a step past K
            const float s0 = __ldg(a.sblk + kb / 16);
            const bool two = kb + 16 < a.K;
            const float s1 = two ? __ldg(a.sblk + kb / 16 + 1) : 0.0f;
            unsigned bf[FN][2];
#pragma unroll
            for (int f = 0; f < FN; ++f) {
                const int8_t* p = Bw + (16 * (f / 2) + f % 2) * A8_LDBT
                    + 32 * ks;
                bf[f][0] = *reinterpret_cast<const unsigned*>(p);
                bf[f][1] = *reinterpret_cast<const unsigned*>(p + 16);
            }
            unsigned av[FM][4];
#pragma unroll
            for (int i = 0; i < FM; ++i) {
                const int c = 32 * ks + 4 * t;
                av[i][0] = a8_lds_a<X16>(X, rb[i][0] + c);
                av[i][1] = a8_lds_a<X16>(X, rb[i][1] + c);
                av[i][2] = a8_lds_a<X16>(X, rb[i][0] + c + 16);
                av[i][3] = a8_lds_a<X16>(X, rb[i][1] + c + 16);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (h == 1 && !two) break;
                int d[FM][FN][4], x[FM][4];
#pragma unroll
                for (int i = 0; i < FM; ++i) {
                    const unsigned am[4] = {
                        h ? 0u : av[i][0], h ? 0u : av[i][1],
                        h ? av[i][2] : 0u, h ? av[i][3] : 0u};
#pragma unroll
                    for (int f = 0; f < FN; ++f)
                        mma_s8_from(d[i][f], am, bf[f][0], bf[f][1],
                                    A8G_MAGIC);
                    mma_s8_from(x[i], am, 0x01010101u, 0x01010101u,
                                A8G_MAGIC);
                }
                a8g_fold<true>(facc, fxs, d, x, h ? s1 : s0);
            }
        }
    };

    // epilogue from registers: lane t holds columns 4t..4t+3 of each group
    // for rows g and g + 8 of each m16 tile (column 4t + c is tile c % 2,
    // element c / 2 of the row's pair); the activation a constant, so
    // that a thread's outputs interleave (a switch an output kept them
    // apart)
    auto epilogue_as = [&](int it, int m0, int n0, auto act_c) {
        constexpr int ACT = decltype(act_c)::value;
        const int split = it / (m_tiles * n_tiles);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
            const int n = n0 + wn * 16 * G + 16 * gi + 4 * t;
            if (n >= a.N) continue;
            const bool vec = a.ovec && n + 3 < a.N;
            // the columns' scale, zero and bias, loaded before any store
            // (y might alias them, as far as the compiler knows)
            float sc[4], zs[4], bias[4];
            if (splits == 1) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int nn = min(n + c, a.N - 1);
                    sc[c] = a.wscale[nn * a.scale_stride] * a.x_scale;
                    zs[c] = a.wzero[nn * a.zero_stride] * sc[c];
                    bias[c] = a.b != nullptr ? a.b[nn] : 0.0f;
                }
            }
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int m = m0 + wm * T::WTM + 16 * i + 8 * h + g;
                    if (m >= a.M) continue;
                    using Acc = std::conditional_t<GROUPED, float, int>;
                    Acc v[4], xsum;
                    if constexpr (GROUPED) {
                        v[0] = facc[i][2 * gi][2 * h];
                        v[1] = facc[i][2 * gi + 1][2 * h];
                        v[2] = facc[i][2 * gi][2 * h + 1];
                        v[3] = facc[i][2 * gi + 1][2 * h + 1];
                        xsum = fxs[i][h];
                    } else {
                        v[0] = acc[i][2 * gi][2 * h];
                        v[1] = acc[i][2 * gi + 1][2 * h];
                        v[2] = acc[i][2 * gi][2 * h + 1];
                        v[3] = acc[i][2 * gi + 1][2 * h + 1];
                        xsum = xs[i][2 * h];
                    }
                    const size_t row = static_cast<size_t>(m) * a.N;
                    if (splits > 1) {
                        Acc* part = reinterpret_cast<Acc*>(
                            GROUPED ? static_cast<void*>(a.fpart)
                                    : static_cast<void*>(a.part));
                        Acc* dst = part + static_cast<size_t>(split) * a.M
                            * a.N + row + n;
                        if (vec) {
                            if constexpr (GROUPED)
                                *reinterpret_cast<float4*>(dst) =
                                    make_float4(v[0], v[1], v[2], v[3]);
                            else
                                *reinterpret_cast<int4*>(dst) =
                                    make_int4(v[0], v[1], v[2], v[3]);
                        } else {
#pragma unroll
                            for (int c = 0; c < 4; ++c)
                                if (n + c < a.N) dst[c] = v[c];
                        }
                        if (gi == 0 && t == 0 && wn == 0 && n0 == 0)
                            part[static_cast<size_t>(splits) * a.M * a.N
                                 + static_cast<size_t>(split) * a.M + m] =
                                xsum;
                        continue;
                    }
                    float o[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        o[c] = a8_fold(v[c], xsum, sc[c], zs[c],
                                       a.b != nullptr, bias[c], ACT);
                    float* dst = a.y + row + n;
                    if (vec) {
                        if (a.res != nullptr) {
                            const float4 r4 = *reinterpret_cast<const float4*>(
                                a.res + row + n);
                            o[0] = __fadd_rn(o[0], r4.x);
                            o[1] = __fadd_rn(o[1], r4.y);
                            o[2] = __fadd_rn(o[2], r4.z);
                            o[3] = __fadd_rn(o[3], r4.w);
                        }
                        *reinterpret_cast<float4*>(dst) =
                            make_float4(o[0], o[1], o[2], o[3]);
                    } else {
#pragma unroll
                        for (int c = 0; c < 4; ++c)
                            if (n + c < a.N)
                                dst[c] = a.res != nullptr
                                    ? __fadd_rn(o[c], a.res[row + n + c])
                                    : o[c];
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

    // The block's slices form one stream across its items: #10 keeps
    // stages - 1 of them in flight, so the next item's first slices load
    // under this item's last MMAs and its epilogue; #8 keeps one, under
    // the MMAs (its epilogue inside the slice loop, to overlap the
    // loads, spilled the loop's registers and took twice the time).
    p_seek();
    int slot = 0;
    bool transpose = true;            // the slice's codes go to Bt
    if constexpr (DOUBLE) {
        for (int s = 0; s + 1 < stages; ++s) produce();
    } else {
        if (p_item < items) {
            fetch();
            put(0);
        }
        __syncthreads();
    }
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int m0, n0, kt0;
        const int n_t = item_tiles(it, m0, n0, kt0);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = wm * T::WTM + 16 * i + 8 * h + g;
                if constexpr (X16) {
                    rb[i][h] = r * A8_LDX16;
                } else {
                    const int off = static_cast<int>(
                        reinterpret_cast<uintptr_t>(a.x + static_cast<size_t>(
                            flat ? m0 : m0 + r) * a.K) & 15);
                    rb[i][h] = flat ? off + r * a.K : r * A8_LDXSPAN + off;
                }
            }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                xs[i][e] = 0;
#pragma unroll
                for (int f = 0; f < FN; ++f) acc[i][f][e] = 0;
            }
        if constexpr (GROUPED) {
#pragma unroll
            for (int i = 0; i < FM; ++i) {
                fxs[i][0] = fxs[i][1] = 0.0f;
#pragma unroll
                for (int f = 0; f < FN; ++f)
#pragma unroll
                    for (int e = 0; e < 4; ++e) facc[i][f][e] = 0.0f;
            }
            g_fresh = true;
            g_blk = kt0 * A8_BK / a.tk;
            g_end = (g_blk + 1) * a.tk;
        }
        for (int s = 0; s < n_t; ++s) {
            if constexpr (DOUBLE) {
                cp_async_wait_n(stages - 2);  // slice landed (this thread)
                __syncthreads();              // ... every thread's; the slot
                produce();                    // and Bt read last are free
                if (transpose) {
                    a8_transpose_b<TBN, PACKED>(Qs + slot * T::Q_STAGE, Bt,
                                                tid);
                    __syncthreads();
                    transpose = !codes_fixed;
                }
                if constexpr (SCALES == A8_BLOCKS16)
                    contract_g16(slot, kt0 + s);
                else if constexpr (GROUPED)
                    contract_g(slot, kt0 + s);
                else
                    contract(slot, kt0 + s);
                slot = slot + 1 == stages ? 0 : slot + 1;
            } else {
                if (transpose) {
                    a8_transpose_b<TBN, PACKED>(Qs + slot * T::Q_STAGE, Bt,
                                                tid);
                    __syncthreads();
                    transpose = !codes_fixed;
                }
                const bool more = p_item < items;
                if (more) fetch();            // loads in flight under the
                contract(slot, kt0 + s);      // MMAs
                if (more) put(slot ^ 1);
                __syncthreads();
                slot ^= 1;
            }
        }
        // #9: a chunk that ends inside a block folds it
        if constexpr (GROUPED)
            if (!g_fresh) fold(__ldg(a.sblk + g_blk));
        epilogue(it, m0, n0);
    }
    if constexpr (DOUBLE) cp_async_wait<0>();
}

// The split-K pass of #8, #9 and #10: each output sums its partials and
// its row's partial row sums in split order (int32 for #8 and #10, exact
// in any order; f32 for #9, the same order every launch), then the
// epilogue.
template <class Acc>
__global__ void __launch_bounds__(A8_THREADS)
qmatmul_a8_split_reduce_kernel(const A8Args a, const Acc* part,
                               int splits) {
    const size_t mn = static_cast<size_t>(a.M) * a.N;
    const size_t i = static_cast<size_t>(blockIdx.x) * A8_THREADS
        + threadIdx.x;
    if (i >= mn) return;
    const int m = static_cast<int>(i / a.N);
    const int n = static_cast<int>(i % a.N);
    const Acc* xs = part + splits * mn;
    Acc acc = 0, xsum = 0;
    for (int s = 0; s < splits; ++s) {
        acc += part[s * mn + i];
        xsum += xs[static_cast<size_t>(s) * a.M + m];
    }
    a.y[i] = a8_output(a, acc, xsum, m, n);
}

// One launch of an instantiation. The grid is persistent: the blocks
// that fit the card at once (A8_RESIDENT an SM), each walking work items
// (m tile, n tile, K chunk) blockIdx.x, blockIdx.x + gridDim.x, ...; the
// SM count and the opt-in to shared memory past 48 KB are read once per
// device. A stage's x holds BM rows of 80 or 112 bytes, or the one range
// of BM·K bytes where K <= A8_BK and x is copied by its blocks (and the
// 68 bytes that the last row's reads may reach past it, rounded up).
template <int TBM, int TBN, bool PACKED, bool X16, bool DOUBLE,
          int SCALES>
cudaError_t launch_a8_tile(const A8Args& a, int splits,
                           cudaStream_t stream) {
    using T = A8Tile<TBM, TBN, PACKED, X16>;
    constexpr int SHARE = A8_SM_SMEM / A8_RESIDENT - A8_BLOCK_RESERVE;
    constexpr int MAX_DEVICES = 16;
    static int sms[MAX_DEVICES] = {};
    auto kern = qmatmul_a8_tc_kernel<TBM, TBN, PACKED, X16, DOUBLE, SCALES>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int n_sm = dev < MAX_DEVICES ? sms[dev] : 0;
    if (n_sm == 0) {
        e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SHARE);
        if (e != cudaSuccess) return e;
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e != cudaSuccess) return e;
        if (dev < MAX_DEVICES) sms[dev] = n_sm;
    }
    const int xstage = X16 ? TBM * A8_LDX16
        : a.K <= A8_BK ? (TBM * a.K + 96 + 15) / 16 * 16
        : TBM * A8_LDXSPAN;
    int stages = 2;                   // #8's two buffers
    if (DOUBLE) {
        stages = (SHARE - T::BT_BYTES) / (xstage + T::Q_STAGE);
        stages = stages > A8_MAX_STAGES ? A8_MAX_STAGES : stages;
    }
    const int smem = stages * (xstage + T::Q_STAGE) + T::BT_BYTES;
    const long long items = static_cast<long long>((a.M + TBM - 1) / TBM)
        * ((a.N + TBN - 1) / TBN) * splits;
    if (items <= 0 || items >= (1LL << 31)) return cudaErrorInvalidValue;
    const long long slots = static_cast<long long>(A8_RESIDENT) * n_sm;
    kern<<<static_cast<unsigned>(items < slots ? items : slots), A8_THREADS,
           smem, stream>>>(a, splits, xstage, stages);
    return cudaGetLastError();
}

// The compiled (BM, BN) tables: REPRO_A8_TILES (#8, #10; kernels/
// qmatmul.py _plan_a8 picks from it) and REPRO_A8G_TILES (#9, _plan_a8g).
template <bool PACKED, bool X16, bool DOUBLE, int SCALES>
cudaError_t launch_a8_table(const A8Args& a, int bm, int bn, int splits,
                            cudaStream_t s) {
#define REPRO_A8_TILE(BM_, BN_)                                           \
    if (bm == BM_ && bn == BN_)                                           \
        return launch_a8_tile<BM_, BN_, PACKED, X16, DOUBLE, SCALES>(     \
            a, splits, s);
    if constexpr (SCALES != A8_TENSOR) {
        REPRO_A8G_TILES
    } else {
        REPRO_A8_TILES
    }
#undef REPRO_A8_TILE
    return cudaErrorInvalidValue;
}

// #8, #9 or #10 (DOUBLE: cp.async stages; SCALES: #9's per-block
// scales): the tile, then the split reduce. a.per is the chunk's slices.
template <bool DOUBLE, int SCALES>
int launch_a8(A8Args a, bool packed, int bm, int bn, int splits, void* ws,
              cudaStream_t stream) {
    constexpr bool GROUPED = SCALES != A8_TENSOR;
    const int k_tiles = (a.K + A8_BK - 1) / A8_BK;
    if (splits < 1 || a.per < 1 || (splits - 1) * a.per >= k_tiles
        || splits * a.per < k_tiles || (splits > 1 && ws == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    a.part = !GROUPED && splits > 1 ? static_cast<int*>(ws) : nullptr;
    a.fpart = GROUPED && splits > 1 ? static_cast<float*>(ws) : nullptr;
    a.qvec = a.N % 16 == 0 && aligned(a.q);
    a.ovec = a.N % 4 == 0 && aligned(a.y)
        && (a.res == nullptr || aligned(a.res))
        && (splits == 1 || aligned(ws));
    const bool x16 = a.K % 16 == 0 && aligned(a.x);
    cudaError_t e;
    if (packed)
        e = x16 ? launch_a8_table<true, true, DOUBLE, SCALES>(
                      a, bm, bn, splits, stream)
                : launch_a8_table<true, false, DOUBLE, SCALES>(
                      a, bm, bn, splits, stream);
    else
        e = x16 ? launch_a8_table<false, true, DOUBLE, SCALES>(
                      a, bm, bn, splits, stream)
                : launch_a8_table<false, false, DOUBLE, SCALES>(
                      a, bm, bn, splits, stream);
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long mn = static_cast<long long>(a.M) * a.N;
    const unsigned grid =
        static_cast<unsigned>((mn + A8_THREADS - 1) / A8_THREADS);
    if constexpr (GROUPED)
        qmatmul_a8_split_reduce_kernel<float><<<grid, A8_THREADS, 0,
                                                stream>>>(a, a.fpart, splits);
    else
        qmatmul_a8_split_reduce_kernel<int><<<grid, A8_THREADS, 0,
                                              stream>>>(a, a.part, splits);
    return static_cast<int>(cudaGetLastError());
}

// The arguments #8, #9 and #10 share.
A8Args a8_args(const int8_t* xq, const int8_t* q, const float* wscale,
               int scale_stride, const float* wzero, int zero_stride,
               float x_scale, const float* b, const float* res, float* y,
               int M, int K, int N, int act) {
    A8Args a{};
    a.x = xq;
    a.q = q;
    a.wscale = wscale;
    a.scale_stride = scale_stride;
    a.wzero = wzero;
    a.zero_stride = zero_stride;
    a.x_scale = x_scale;
    a.b = b;
    a.res = res;
    a.y = y;
    a.M = M;
    a.K = K;
    a.N = N;
    a.act = act;
    return a;
}

}  // namespace

extern "C" int repro_qmatmul_f32(
        const float* x, const void* q, int code_kind, const float* scale,
        int scale_stride, const float* zero, int zero_stride,
        const float* b, const float* res, float* y, int M, int K, int N,
        int act, int bm, int bn, int splits, float* ws,
        cudaStream_t stream) {
    if (splits < 1 || (splits > 1 && ws == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int esize = code_kind == CODES_INT16 ? 2 : 1;
    auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const QmmArgs a{x, q, scale, scale_stride, zero, zero_stride, b, res,
                    y, splits > 1 ? ws : nullptr, M, K, N, act,
                    (N * esize) % 16 == 0 && aligned(q),
                    N % 4 == 0 && aligned(y)
                        && (res == nullptr || aligned(res))
                        && (splits == 1 || aligned(ws))};
    const bool x16 = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    cudaError_t e;
    switch (code_kind) {
    case CODES_INT8:
        e = launch_tc<CODES_INT8>(a, bm, bn, x16, splits, stream);
        break;
    case CODES_INT16:
        e = launch_tc<CODES_INT16>(a, bm, bn, x16, splits, stream);
        break;
    case CODES_PACKED4:
        e = launch_tc<CODES_PACKED4>(a, bm, bn, x16, splits, stream);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long mn = static_cast<long long>(M) * N;
    qmatmul_split_reduce_kernel<<<
        static_cast<unsigned>((mn + TC_THREADS - 1) / TC_THREADS),
        TC_THREADS, 0, stream>>>(a, splits);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_qmatmul_a8(
        const int8_t* xq, const int8_t* q, int packed, const float* wscale,
        int scale_stride, const float* wzero, int zero_stride,
        float x_scale, const float* b, const float* res, float* y, int M,
        int K, int N, int act, int bm, int bn, int splits, int* ws,
        cudaStream_t stream) {
    A8Args a = a8_args(xq, q, wscale, scale_stride, wzero, zero_stride,
                       x_scale, b, res, y, M, K, N, act);
    a.per = splits < 1 ? 0 : ((K + A8_BK - 1) / A8_BK + splits - 1) / splits;
    return launch_a8<false, A8_TENSOR>(a, packed != 0, bm, bn, splits, ws,
                                       stream);
}

extern "C" int repro_qmatmul_a8_double(
        const int8_t* xq, const int8_t* q, int packed, const float* wscale,
        int scale_stride, const float* wzero, int zero_stride,
        float x_scale, const float* b, const float* res, float* y, int M,
        int K, int N, int act, int bm, int bn, int splits, int* ws,
        cudaStream_t stream) {
    A8Args a = a8_args(xq, q, wscale, scale_stride, wzero, zero_stride,
                       x_scale, b, res, y, M, K, N, act);
    a.per = splits < 1 ? 0 : ((K + A8_BK - 1) / A8_BK + splits - 1) / splits;
    return launch_a8<true, A8_TENSOR>(a, packed != 0, bm, bn, splits, ws,
                                      stream);
}

// #9: sblk holds one scale a block of tk features (K % tk == 0); the plan
// (kernels/qmatmul.py _plan_a8g) gives the tile, the splits and the
// slices a chunk; ws the f32 scratch of a split, splits·M·(N + 1). K
// slices come in by cp.async, as #10's (through registers, as #8's, the
// f32 sums beside the int32 ones spilled and read slower).
extern "C" int repro_qmatmul_a8_grouped(
        const int8_t* xq, const int8_t* q, int packed, const float* sblk,
        int tk, const float* wscale, int scale_stride, const float* wzero,
        int zero_stride, const float* b, const float* res, float* y, int M,
        int K, int N, int act, int bm, int bn, int splits, int per,
        float* ws, cudaStream_t stream) {
    if (tk <= 0 || K % tk != 0 || sblk == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    A8Args a = a8_args(xq, q, wscale, scale_stride, wzero, zero_stride,
                       1.0f, b, res, y, M, K, N, act);
    a.per = per;
    a.sblk = sblk;
    a.tk = tk;
    // |a block's sum| < 2^22: 2^14 a product of int8 codes, 2^10 of int4
    a.magic = static_cast<long long>(tk) * (packed ? 1024 : 16384)
        < (1LL << 22);
    return tk == 16
        ? launch_a8<true, A8_BLOCKS16>(a, packed != 0, bm, bn, splits, ws,
                                       stream)
        : launch_a8<true, A8_BLOCKS>(a, packed != 0, bm, bn, splits, ws,
                                     stream);
}
