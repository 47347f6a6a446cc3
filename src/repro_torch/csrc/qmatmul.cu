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
// #8-#10 (int8 activations): one 256-thread block owns a 64 x 64 tile,
// every thread a 4 x 4 register tile of int32 accumulators and the row
// sums of its 4 rows, on __dp4a in the CUDA cores. Their bound is bytes
// against the int8 tensor-core peak (1979 TOPS), far from where they run;
// wgmma, int8 mma.sync and TMA are later work.
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

#include "common.cuh"
// #7's plan table, REPRO_QMM_BK and REPRO_QMM_TILES: written into the
// build by kernels/_build.py from kernels/qmatmul.py (_BK, TILES), the one
// place the table is kept.
#include "qmm_tiles.h"

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

__device__ __forceinline__ unsigned to_tf32(float v) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// d += a·b on the tensor cores: m16n8k8, TF32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a·b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
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
