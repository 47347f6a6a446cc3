// Mamba-2 SSD (state-space duality) chunked scan, float32 in and out, on
// the TF32 tensor cores at fp32 accuracy: y (Bt, T, H, P) and the final
// state (Bt, H, N, P) from x (Bt, T, H, P), dt (Bt, T, H), A (H,), B and C
// (Bt, T, G, N) per group, and an optional initial state h0 (Bt, H, N, P).
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan.py (`ssd_scan`
// :64, `_ssd_kernel` :24, pallas_call :82), and covers everything
// nn/ssm.py:ssd_chunked computes (it also takes h0, where the Pallas
// kernel starts from zero). The Pallas grid (batch, head tile, chunk) runs
// the chunk axis in order on one core with the state in VMEM. Blocks on
// this card run in no order on 132 SMs, so the chunk axis is taken apart
// as the SSD paper's GPU form does (arXiv:2405.21060, §6): only the state
// recurrence between chunks is sequential, and it is a cheap elementwise
// pass of its own. Per chunk of L = 64 tokens (the kernel's own tile:
// any chunk is the same function), with cs the inclusive cumulative sum
// of dt·A restarting each chunk:
//   pass 1 (ssd_chunk_state), every chunk at once:
//     dS_c = Σ_s B_s ⊗ (exp(cs_last − cs_s)·dt_s·x_s)  (Bᵀ·(w ⊙ x), N x P
//            a head), and cs written to the scratch; the blocks of a
//            second role compute CB = C·Bᵀ (L x L) ONCE per (batch,
//            group, chunk) into the scratch;
//   pass 2 (ssd_state_pass), per (batch, head, 1024 state entries), the
//     only sequential part, elementwise and bound by bytes:
//     S_c = exp(cs_last,c)·S_{c−1} + dS_c from h0 (or 0), overwriting
//     dS_c with the state entering chunk c (c >= 1) and writing the final
//     state;
//   pass 3 (ssd_chunk_out), every chunk at once:
//     y_t = Σ_{s<=t} CB[t][s]·exp(cs_t − cs_s)·dt_s·x_s
//           + exp(cs_t)·(C_t · S_{c−1}),
//     the block's CB and C staged once in shared memory and reused by
//     every head of its head tile (and by every warp: CB is never
//     recomputed per head or per P tile).
// One chunk (T <= L): pass 1 writes the final state itself (exp(cs_last)·
// h0 + dS_0) and pass 2 is not launched. At most three launches a call.
//
// * The exponent is never taken where s > t (it is positive there and
//   would overflow), as the JAX code masks it before exp.
// * Head h reads group h / (H / G) of B and C by index; the `repeat` of
//   the JAX code is never made. A block of passes 1 and 3 owns a tile of
//   up to REPRO_SSD_HEADS heads of ONE group and a tile of 32 columns of
//   P (the last one 16 wide where P % 32 = 16); the head tile comes from
//   kernels/ssd_scan.py `_plan` (the fewest waves of
//   pass 3's blocks over the card, times a block's work).
// * A ragged last chunk, and T below one chunk, stage zeros past T with
//   dt = 0: decay 1 and no input, so y and S are unchanged by them. Loops
//   over tokens stop at the last 8-token step that holds one.
//
// Arithmetic. The four products (C·Bᵀ, W·x, C·S and Bᵀ·(w ⊙ x)) run on
// the tensor cores (mma.sync m16n8k8 TF32, fragments built by hand). TF32
// keeps 11 significant bits, so every operand is split into two TF32
// values, both rounded to nearest (cvt.rna): hi = tf32(v), lo = tf32(v −
// hi); v − hi is exact in f32 and |v − hi − lo| <= 2^-22 |v|. A product
// is three MMAs, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, each partial product
// exact: at most 3·2^-22 |a·b| (7.2e-7) lost, as in csrc/conv2d.cu and
// csrc/attention.cu. The tensor cores add with truncation, so no chain of
// MMAs carries a running sum: every 8-wide step is one fresh accumulator
// of its three MMAs (a_hi·b_hi from zero, then the two cross terms),
// added to the running sum in f32 on the CUDA cores. The B operands that
// every warp of a block reads (w ⊙ x, x, S) are split once as they are
// staged, into (hi, lo) float2 pairs, one 8-byte load a fragment value;
// the A operands (Bᵀ, C, W) are split in registers as each warp loads its
// own fragment, once for the 4 n8 tiles of its 32 columns. W is never
// stored: a lane builds its A fragment of W·x from CB, cs and dt. The
// decay products, the state pass and the final fmaf of y are f32 FMAs.
//
// The MMAs of a unit go out in waves over its independent chains (two
// 8-wide steps x 4 n8 tiles: the eight a_hi·b_hi, then the eight
// a_hi·b_lo, then the eight a_lo·b_hi), so no MMA is issued right behind
// the one it waits on (issued tile by tile, each chain stalls the warp).
// W below the warp's diagonal 16 x 16 block is CB[t][s]·exp(cs_t −
// cs_e)·gamma_s, with e the last token of s's 16 and gamma_s = exp(cs_e −
// cs_s)·dt_s computed once a head: both exponents <= 0 there, two
// exponentials a lane a 16-token block instead of eight.
//
// Fragments (layouts fixed by the PTX ISA): lane (g = lane / 4, t = lane
// % 4) holds A at rows g, g + 8 and columns t, t + 4; B at rows t, t + 4
// and column g; C at rows g, g + 8 and columns 2t, 2t + 1. A warp owns
// units of 16 rows x 32 columns (4 n8 tiles). Row strides are chosen so
// that a fragment load hits 32 distinct banks: raw f32 rows read as A at
// (g, t) have a stride of 4 (mod 32) floats (C, CB: N + 4, L + 4; the B
// rows of C·Bᵀ, a K slice of 64 + 4), raw rows read as Bᵀ at (t, g) a
// stride of 8 (mod 16) (B in pass 1: N + 8), and (hi, lo) pair rows read
// at (t, g) a stride of 4 (mod 16) pairs (36 for a 32-column tile).
//
// Staging. What is copied as it is (B in pass 1, C and CB in pass 3, the
// slices of C·Bᵀ) comes in by cp.async, 16 bytes at a time, zero-filled
// past T; what is split on the way (x, w ⊙ x, the entering state) is
// loaded into registers a head ahead, while the head before it is
// contracted, and split into shared memory after a barrier, so a block
// waits on device memory about once a head rather than once a float4 a
// thread.
// Pass 3 takes 110 KB at L = 64 (two blocks an SM, 4 warps each). L = 128
// (216 KB, one block an SM) read slower at every case on the H100, and is
// not built.
//
// Scratch (the f32 buffer of the (device, stream) that #1's split K also
// uses, kernels/_build.py `scratch_slot`, grown and reused): the chunk
// states (Bt, nc, H, N, P) where nc > 1, cs (Bt, nc, H, L), CB (Bt, nc,
// G, L, L).
//
// Bound on this card, the function's own: max(3 · the FLOPs of the
// chunked algorithm at its least-work chunk / 495 TFLOP/s dense TF32,
// bytes / 3.35 TB/s), the bytes being x, dt, A, B, C and h0 read once and
// y and the final state written once. This route also moves the chunk
// states four times through device memory (pass 1 writes them, pass 2
// reads and rewrites them, pass 3 reads them), which a fused design
// would not; chip_smoke.py prints those bytes, and the fp32 least-work
// bound, beside each case.
#include "common.cuh"
// REPRO_SSD_CHUNK, REPRO_SSD_HEADS, REPRO_SSD_PT: written into the build
// by kernels/_build.py from kernels/ssd_scan.py (SSD_CHUNK, SSD_HEADS,
// SSD_PT), the one place the table is kept.
#include "ssd_tiles.h"

namespace {

constexpr int PT = REPRO_SSD_PT;    // columns of P a block owns
constexpr int PS = PT + 4;          // (hi, lo) pair stride of a P tile row
constexpr int MAX_HT = REPRO_SSD_HEADS;
constexpr int KS = 64;              // columns of N a C·Bᵀ slice stages
constexpr int KSS = KS + 4;
constexpr int STATE_THREADS = 256;
constexpr int kMaxDevices = 64;
constexpr int NJ = 4;                   // n8 tiles of a 32-column unit
static_assert(PT == 8 * NJ, "a unit spans a P tile");
// A block of passes 1 and 3 is L / 16 warps (2L threads): in pass 3 one
// warp a 16-row slice of the chunk over the block's 32 columns (two warps
// a slice, each half the columns, read slower: the A fragments, W's
// above all, are then built twice).
template <int L>
struct Block {
    static constexpr int NW = L / 16;
    static constexpr int NT = 32 * NW;
    static_assert(L % 16 == 0 && NT <= 1024, "chunk");
};

__device__ __forceinline__ unsigned bits(float v) {
    return __float_as_uint(v);
}

// v = hi + lo + O(2^-22 |v|), both TF32 rounded to nearest.
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split2(float v) {
    unsigned hi, lo;
    split(v, hi, lo);
    return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// Four floats split into two float4 of (hi, lo) pairs at dst (16-byte
// aligned, 8 floats).
__device__ __forceinline__ void store_split4(float2* dst, float4 v) {
    const float2 a = split2(v.x), b = split2(v.y), c = split2(v.z),
                 d = split2(v.w);
    float4* p = reinterpret_cast<float4*>(dst);
    p[0] = make_float4(a.x, a.y, b.x, b.y);
    p[1] = make_float4(c.x, c.y, d.x, d.y);
}

// The A fragment (hi and lo) of four f32 values.
__device__ __forceinline__ void split_a(float v0, float v1, float v2,
                                        float v3, unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
    split(v0, hi[0], lo[0]);
    split(v1, hi[1], lo[1]);
    split(v2, hi[2], lo[2]);
    split(v3, hi[3], lo[3]);
}

// The B fragments (hi and lo) of the NJ n8 tiles of a unit at step k0,
// from (hi, lo) pair rows k0 + t and k0 + t + 4 of `s` (stride PS),
// column 8j + g; tiles at or past `width` columns are not read.
__device__ __forceinline__ void frag_b(unsigned (&bh)[NJ][2],
                                       unsigned (&bl)[NJ][2],
                                       const float2* s, int k0, int width,
                                       int g, int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        bh[j][0] = bh[j][1] = bl[j][0] = bl[j][1] = 0u;
        if (8 * j >= width) continue;
        const float2 v0 = s[(k0 + t) * PS + 8 * j + g];
        const float2 v1 = s[(k0 + t + 4) * PS + 8 * j + g];
        bh[j][0] = bits(v0.x);
        bh[j][1] = bits(v1.x);
        bl[j][0] = bits(v0.y);
        bl[j][1] = bits(v1.y);
    }
}

// acc[j] += a_u·b_u[j] over U 8-wide steps u and the NJ n8 tiles j of a
// unit (tiles at or past `width` columns skipped): each (step, tile) is
// three TF32 MMAs in a fresh accumulator (a_hi·b_hi from zero, then the
// two cross terms), added to acc in f32 step by step, in step order. The
// MMAs go out a wave at a time, one MMA of each of the U·4 independent
// chains a wave, so that no MMA is issued right behind the one it waits
// on.
template <int U>
__device__ __forceinline__ void mma3_steps(float (&acc)[NJ][4],
                                           const unsigned (&ah)[U][4],
                                           const unsigned (&al)[U][4],
                                           const unsigned (&bh)[U][NJ][2],
                                           const unsigned (&bl)[U][NJ][2],
                                           int width) {
    float d[U][NJ][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            if (8 * j < width)
                mma_tf32_first(d[u][j], ah[u], bh[u][j][0], bh[u][j][1]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            if (8 * j < width)
                mma_tf32(d[u][j], ah[u], bl[u][j][0], bl[u][j][1]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            if (8 * j < width)
                mma_tf32(d[u][j], al[u], bh[u][j][0], bh[u][j][1]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            if (8 * j < width)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] += d[u][j][e];
}

// The P tile [p0, p0 + pw) of `rows` rows of a row-major matrix of P
// columns at `src` (rows at or past `valid` zero), R float4 a thread
// (thread f's i-th at row (f + i·NT) / 8, float4 (f + i·NT) % 8), loaded
// together into registers: every load of a stage in flight at once.
template <int R, int NT>
__device__ __forceinline__ void load_tile(float4 (&v)[R], const float* src,
                                          long long stride, int rows,
                                          int valid, int p0, int pw) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int f = threadIdx.x + i * NT, r = f / (PT / 4),
                  q = f % (PT / 4);
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows && r < valid && 4 * q < pw)
            v[i] = *reinterpret_cast<const float4*>(src + r * stride + p0
                                                    + 4 * q);
    }
}

// The same registers split into (hi, lo) pairs at their rows of `dst`
// (stride PS), each row scaled by scale[row] where given.
template <int R, int NT>
__device__ __forceinline__ void store_tile(const float4 (&v)[R], float2* dst,
                                           int rows, const float* scale) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int f = threadIdx.x + i * NT, r = f / (PT / 4),
                  q = f % (PT / 4);
        if (r >= rows) break;
        float4 u = v[i];
        if (scale) {
            const float w = scale[r];
            u = make_float4(u.x * w, u.y * w, u.z * w, u.w * w);
        }
        store_split4(dst + r * PS + 4 * q, u);
    }
}

// cs (the inclusive cumulative sum of dt·A over the chunk) and dt of
// lane's E = L / 32 consecutive tokens of head h, one warp a head; `last`
// is the chunk's cs_last (cs is flat past `valid`: dt = 0 there).
template <int L>
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             float a, long long row0,
                                             int valid, int H, int h,
                                             int lane, float (&cs)[L / 32],
                                             float (&d)[L / 32],
                                             float& last) {
    constexpr int E = L / 32;
    float run = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int s = lane * E + e;
        d[e] = s < valid ? dt[(row0 + s) * H + h] : 0.0f;
        run += d[e] * a;
        cs[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) cs[e] += excl;
    last = __shfl_sync(0xffffffffu, incl, 31);
}

// ---------------------------------------------------------------- pass 1
// Blocks (role, chunk, batch). Roles below G·nht·npt: the chunk states of
// head tile (group, jt) over P tile pt; the G after: CB of a group.
template <int L>
__global__ void __launch_bounds__(Block<L>::NT)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, const float* __restrict__ h0,
                float* __restrict__ states, float* __restrict__ s_out,
                float* __restrict__ cs_out, float* __restrict__ cb_out,
                int T, int H, int G, int N, int P, int nc, int ht, int nht,
                int npt) {
    constexpr int NW = Block<L>::NW, NT = Block<L>::NT;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    const int c = blockIdx.y, b = blockIdx.z;
    const int t0 = c * L, valid = min(L, T - t0);
    const int kend = min(L, (valid + 7) & ~7);
    const long long row0 = static_cast<long long>(b) * T + t0;
    const int role = blockIdx.x, tiles = G * nht * npt;

    if (role >= tiles) {
        // CB = C·Bᵀ of group g, rows and columns the chunk's tokens, only
        // the 16 x 32 units that reach the causal half (column start <=
        // row end), over K slices of 64 columns of N.
        const int g = role - tiles;
        float* sC = smem;
        float* sB = sC + L * KSS;
        constexpr int RT = L / 16;
        constexpr int UNITS = RT * (RT + 2) / 4;   // Σ_rt (rt / 2 + 1)
        constexpr int UMAX = (UNITS + NW - 1) / NW;
        int urt[UMAX], uct[UMAX];
#pragma unroll
        for (int i = 0; i < UMAX; ++i) {
            int u = warp + i * NW, rt = 0;
            while (rt < RT && u >= rt / 2 + 1) u -= rt / 2 + 1, ++rt;
            urt[i] = rt;                // rt == RT: no unit
            uct[i] = u;
        }
        float acc[UMAX][4][4];
#pragma unroll
        for (int i = 0; i < UMAX; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        for (int kb = 0; kb < N; kb += KS) {
            const int kw = min(KS, N - kb);
            __syncthreads();
            for (int f = threadIdx.x; f < L * (KS / 4); f += NT) {
                const int s = f / (KS / 4), q = f % (KS / 4);
                const bool ok = s < valid && 4 * q < kw;
                const long long off = ok ? ((row0 + s) * G + g) * N + kb
                    + 4 * q : 0;
                cp_async16(sC + s * KSS + 4 * q, C + off, ok);
                cp_async16(sB + s * KSS + 4 * q, B + off, ok);
            }
            cp_async_commit();
            cp_async_wait<0>();
            __syncthreads();
#pragma unroll
            for (int i = 0; i < UMAX; ++i) {
                if (urt[i] >= RT || 16 * urt[i] >= valid) continue;
                const float* cr = sC + (16 * urt[i] + g8) * KSS;
                for (int k0 = 0; k0 < kw; k0 += 16) {    // kw % 16 == 0
                    unsigned ah[2][4], al[2][4], bh[2][4][2], bl[2][4][2];
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int k = k0 + 8 * u + t4;
                        split_a(cr[k], cr[8 * KSS + k], cr[k + 4],
                                cr[8 * KSS + k + 4], ah[u], al[u]);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const float* br =
                                sB + (32 * uct[i] + 8 * j + g8) * KSS + k;
                            split(br[0], bh[u][j][0], bl[u][j][0]);
                            split(br[4], bh[u][j][1], bl[u][j][1]);
                        }
                    }
                    mma3_steps<2>(acc[i], ah, al, bh, bl, PT);
                }
            }
        }
        float* out = cb_out
            + ((static_cast<long long>(b) * nc + c) * G + g) * L * L;
#pragma unroll
        for (int i = 0; i < UMAX; ++i) {
            if (urt[i] >= RT || 16 * urt[i] >= valid) continue;
            const int r = 16 * urt[i] + g8;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int s = 32 * uct[i] + 8 * j + 2 * t4;
                *reinterpret_cast<float2*>(out + r * L + s) =
                    make_float2(acc[i][j][0], acc[i][j][1]);
                *reinterpret_cast<float2*>(out + (r + 8) * L + s) =
                    make_float2(acc[i][j][2], acc[i][j][3]);
            }
        }
        return;
    }

    // chunk states of the heads [hb, he) over columns [p0, p0 + pw)
    const int pt = role % npt, jt = (role / npt) % nht,
              g = role / (npt * nht);
    const int rep = H / G;
    const int hb = g * rep + jt * ht, he = min(hb + ht, (g + 1) * rep);
    const int p0 = pt * PT, pw = min(PT, P - p0);
    const int NB = N + 8;
    float* sB = smem;                                   // L x NB, raw
    float2* sX = reinterpret_cast<float2*>(sB + L * NB);   // L x PS pairs
    float* sW = reinterpret_cast<float*>(sX + L * PS);  // MAX_HT x L
    float* sLast = sW + MAX_HT * L;                     // MAX_HT

    const int VB = N / 4;
    for (int f = threadIdx.x; f < L * VB; f += NT) {
        const int s = f / VB, q = f % VB;
        const long long off = s < valid ? ((row0 + s) * G + g) * N + 4 * q
                                        : 0;
        cp_async16(sB + s * NB + 4 * q, B + off, s < valid);
    }
    cp_async_commit();
    // x of the first head in flight beside B; each later head's is
    // loaded while the head before it is contracted
    constexpr int XR = L * (PT / 4) / NT;
    float4 xr[XR];
    const long long xs = static_cast<long long>(H) * P;
    load_tile<XR, NT>(xr, x + row0 * xs + static_cast<long long>(hb) * P,
                      xs, L, valid, p0, pw);
    for (int hi = warp; hi < he - hb; hi += NW) {
        const int h = hb + hi;
        float cs[L / 32], d[L / 32], last;
        chunk_cumsum<L>(dt, A[h], row0, valid, H, h, lane, cs, d, last);
        float* csg = cs_out
            + ((static_cast<long long>(b) * nc + c) * H + h) * L;
#pragma unroll
        for (int e = 0; e < L / 32; ++e) {
            const int s = lane * (L / 32) + e;
            sW[hi * L + s] = expf(last - cs[e]) * d[e];
            if (pt == 0) csg[s] = cs[e];
        }
        if (lane == 0) sLast[hi] = last;
    }
    const bool one_chunk = nc == 1;
    cp_async_wait<0>();
    for (int hi = 0; hi < he - hb; ++hi) {
        const int h = hb + hi;
        __syncthreads();                // B, sW ready; last head's sX read
        store_tile<XR, NT>(xr, sX, L, sW + hi * L);
        __syncthreads();
        if (h + 1 < he)
            load_tile<XR, NT>(xr, x + row0 * xs
                              + static_cast<long long>(h + 1) * P, xs, L,
                              valid, p0, pw);
        const long long head = static_cast<long long>(b) * H + h;
        float* dst = one_chunk
            ? s_out + head * N * P
            : states + ((static_cast<long long>(b) * nc + c) * H + h) * N
                * P;
        const float* s0 = one_chunk && h0 ? h0 + head * N * P : nullptr;
        const float e_last = s0 ? expf(sLast[hi]) : 0.0f;
        for (int mt = warp; mt < N / 16; mt += NW) {
            float acc[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
            const float* br = sB + 16 * mt + g8;
            // A = Bᵀ: rows n of the unit, columns the step's tokens
            auto frag = [&](int k, unsigned (&ah)[4], unsigned (&al)[4]) {
                const float* r0 = br + (k + t4) * NB;
                const float* r1 = br + (k + t4 + 4) * NB;
                split_a(r0[0], r0[8], r1[0], r1[8], ah, al);
            };
            int k0 = 0;
            for (; k0 + 16 <= kend; k0 += 16) {
                unsigned ah[2][4], al[2][4], bh[2][NJ][2], bl[2][NJ][2];
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                    frag(k0 + 8 * v, ah[v], al[v]);
                    frag_b(bh[v], bl[v], sX, k0 + 8 * v, pw, g8, t4);
                }
                mma3_steps<2>(acc, ah, al, bh, bl, pw);
            }
            if (k0 < kend) {
                unsigned ah[1][4], al[1][4], bh[1][NJ][2], bl[1][NJ][2];
                frag(k0, ah[0], al[0]);
                frag_b(bh[0], bl[0], sX, k0, pw, g8, t4);
                mma3_steps<1>(acc, ah, al, bh, bl, pw);
            }
            const int n = 16 * mt + g8;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                if (8 * j >= pw) break;
                const int p = p0 + 8 * j + 2 * t4;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const long long at = static_cast<long long>(
                        n + 8 * half) * P + p;
                    float2 v = make_float2(acc[j][2 * half],
                                           acc[j][2 * half + 1]);
                    if (s0) {
                        const float2 o =
                            *reinterpret_cast<const float2*>(s0 + at);
                        v = make_float2(fmaf(e_last, o.x, v.x),
                                        fmaf(e_last, o.y, v.y));
                    }
                    *reinterpret_cast<float2*>(dst + at) = v;
                }
            }
        }
    }
}

// ---------------------------------------------------------------- pass 2
// Blocks (state entries / 1024, head, batch); a thread walks the chunks
// for 4 adjacent state entries, four chunks' dS loaded ahead.
__global__ void __launch_bounds__(STATE_THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ cs,
               const float* __restrict__ h0, float* __restrict__ s_out,
               int H, int NP4, int nc, int L) {
    const int i = blockIdx.x * STATE_THREADS + threadIdx.x;
    if (i >= NP4) return;
    const int h = blockIdx.y, b = blockIdx.z;
    const long long head = static_cast<long long>(b) * H + h;
    float4 S = h0 ? reinterpret_cast<const float4*>(h0)[head * NP4 + i]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4* st = reinterpret_cast<float4*>(states);
    for (int c0 = 0; c0 < nc; c0 += 4) {
        float4 d[4];
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = c0 + u;
            if (c >= nc) break;
            const long long ch = (static_cast<long long>(b) * nc + c) * H
                + h;
            d[u] = st[ch * NP4 + i];
            e[u] = expf(cs[ch * L + L - 1]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = c0 + u;
            if (c >= nc) break;
            const long long ch = (static_cast<long long>(b) * nc + c) * H
                + h;
            if (c > 0) st[ch * NP4 + i] = S;    // the state entering c
            S = make_float4(fmaf(e[u], S.x, d[u].x), fmaf(e[u], S.y, d[u].y),
                            fmaf(e[u], S.z, d[u].z),
                            fmaf(e[u], S.w, d[u].w));
        }
    }
    reinterpret_cast<float4*>(s_out)[head * NP4 + i] = S;
}

// ---------------------------------------------------------------- pass 3
// Blocks (head tile x P tile, chunk, batch), L / 16 warps: warp w owns
// rows 16w..16w+15 of the chunk over the block's 32 columns of P.
template <int L>
__global__ void __launch_bounds__(Block<L>::NT)
ssd_chunk_out(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ C, const float* __restrict__ h0,
              const float* __restrict__ states, const float* __restrict__ cs,
              const float* __restrict__ cb, float* __restrict__ y, int T,
              int H, int G, int N, int P, int nc, int ht, int nht, int npt) {
    constexpr int NT = Block<L>::NT;
    constexpr int LS = L + 4;
    extern __shared__ float4 smem4[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g8 = lane / 4, t4 = lane % 4;
    const int role = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int pt = role % npt, jt = (role / npt) % nht,
              g = role / (npt * nht);
    const int rep = H / G;
    const int hb = g * rep + jt * ht, he = min(hb + ht, (g + 1) * rep);
    const int p0 = pt * PT, pw = min(PT, P - p0);
    const int t0 = c * L, valid = min(L, T - t0);
    const long long row0 = static_cast<long long>(b) * T + t0;
    const bool has_s = c > 0 || h0 != nullptr;
    const int NC = N + 4;
    float* sCB = reinterpret_cast<float*>(smem4);       // L x LS, raw
    float* sCs = sCB + L * LS;                          // MAX_HT x L
    float* sDt = sCs + MAX_HT * L;                      // MAX_HT x L
    float* sG = sDt + MAX_HT * L;                       // MAX_HT x L
    float2* sX = reinterpret_cast<float2*>(sG + MAX_HT * L);   // L x PS
    float2* sS = sX + L * PS;                           // N x PS pairs
    float* sC = reinterpret_cast<float*>(sS + N * PS);  // L x NC, raw

    const float* cbg = cb
        + ((static_cast<long long>(b) * nc + c) * G + g) * L * L;
    for (int f = threadIdx.x; f < L * (L / 4); f += NT) {
        const int r = f / (L / 4), q = f % (L / 4);
        cp_async16(sCB + r * LS + 4 * q, cbg + r * L + 4 * q, true);
    }
    if (has_s) {
        const int VC = N / 4;
        for (int f = threadIdx.x; f < L * VC; f += NT) {
            const int s = f / VC, q = f % VC;
            const long long off = s < valid
                ? ((row0 + s) * G + g) * N + 4 * q : 0;
            cp_async16(sC + s * NC + 4 * q, C + off, s < valid);
        }
    }
    cp_async_commit();
    // x and the entering state of the first head in flight beside them;
    // each later head's are loaded while the head before it is contracted
    constexpr int XR = L * (PT / 4) / NT;
    constexpr int SR = 128 * (PT / 4) / NT;     // N <= 128
    float4 xr[XR], sr[SR];
    const long long xs = static_cast<long long>(H) * P;
    auto entering = [&](int h) -> const float* {
        return c > 0 ? states + ((static_cast<long long>(b) * nc + c) * H
                                 + h) * N * P
                     : h0 + (static_cast<long long>(b) * H + h) * N * P;
    };
    load_tile<XR, NT>(xr, x + row0 * xs + static_cast<long long>(hb) * P,
                      xs, L, valid, p0, pw);
    if (has_s) load_tile<SR, NT>(sr, entering(hb), P, N, N, p0, pw);
    for (int f = threadIdx.x; f < (he - hb) * L; f += NT) {
        const int hi = f / L, s = f % L, h = hb + hi;
        const float* csh =
            cs + ((static_cast<long long>(b) * nc + c) * H + h) * L;
        const float d = s < valid ? dt[(row0 + s) * H + h] : 0.0f;
        sCs[hi * L + s] = csh[s];
        sDt[hi * L + s] = d;
        // gamma_s = exp(cs_e − cs_s)·dt_s, e the last token of s's 16
        sG[hi * L + s] = expf(csh[s | 15] - csh[s]) * d;
    }
    const int rt = warp;
    const int r0 = 16 * rt + g8, r1 = r0 + 8;
    const bool rows = 16 * rt < valid;
    const int kw = min(16 * rt + 16, (valid + 7) & ~7);
    cp_async_wait<0>();
    for (int hi = 0; hi < he - hb; ++hi) {
        const int h = hb + hi;
        __syncthreads();                // CB, C, cs, dt ready; last head's
                                        // sX, sS read
        store_tile<XR, NT>(xr, sX, L, nullptr);
        if (has_s) store_tile<SR, NT>(sr, sS, N, nullptr);
        __syncthreads();
        if (h + 1 < he) {
            load_tile<XR, NT>(xr, x + row0 * xs
                              + static_cast<long long>(h + 1) * P, xs, L,
                              valid, p0, pw);
            if (has_s) load_tile<SR, NT>(sr, entering(h + 1), P, N, N, p0,
                                         pw);
        }
        if (!rows) continue;
        const float* cst = sCs + hi * L;
        const float* dtt = sDt + hi * L;
        const float cs0 = cst[r0], cs1 = cst[r1];
        float ya[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ya[j][e] = 0.0f;
        // W·x over the causal steps: W[r][s] = CB·exp(cs_r − cs_s)·dt_s.
        // Below the warp's diagonal 16 x 16 block the exponential is
        // factored at the last token e of s's 16: exp(cs_r − cs_e)·gamma_s,
        // both exponents <= 0 there (cs falls along the chunk), so two
        // exponentials a lane a 16-token block replace sixteen.
        const float* gt = sG + hi * L;
        auto wfrag_off = [&](int k, float rho0, float rho1,
                             unsigned (&ah)[4], unsigned (&al)[4]) {
            const int sa = k + t4, sb = sa + 4;
            const float ga = gt[sa], gb = gt[sb];
            split_a(sCB[r0 * LS + sa] * rho0 * ga,
                    sCB[r1 * LS + sa] * rho1 * ga,
                    sCB[r0 * LS + sb] * rho0 * gb,
                    sCB[r1 * LS + sb] * rho1 * gb, ah, al);
        };
        auto wfrag = [&](int k, unsigned (&ah)[4], unsigned (&al)[4]) {
            const int sa = k + t4, sb = sa + 4;
            const float ca = cst[sa], cb4 = cst[sb];
            const float da = dtt[sa], db = dtt[sb];
            const float w0 = sa <= r0
                ? sCB[r0 * LS + sa] * expf(cs0 - ca) * da : 0.0f;
            const float w1 = sa <= r1
                ? sCB[r1 * LS + sa] * expf(cs1 - ca) * da : 0.0f;
            const float w2 = sb <= r0
                ? sCB[r0 * LS + sb] * expf(cs0 - cb4) * db : 0.0f;
            const float w3 = sb <= r1
                ? sCB[r1 * LS + sb] * expf(cs1 - cb4) * db : 0.0f;
            split_a(w0, w1, w2, w3, ah, al);
        };
        int k0 = 0;
        for (; k0 + 16 <= kw; k0 += 16) {
            unsigned ah[2][4], al[2][4], bh[2][NJ][2], bl[2][NJ][2];
            const bool below = k0 < 16 * rt;
            const float ce = cst[k0 + 15];
            const float rho0 = below ? expf(cs0 - ce) : 0.0f;
            const float rho1 = below ? expf(cs1 - ce) : 0.0f;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                if (below)
                    wfrag_off(k0 + 8 * u, rho0, rho1, ah[u], al[u]);
                else
                    wfrag(k0 + 8 * u, ah[u], al[u]);
                frag_b(bh[u], bl[u], sX, k0 + 8 * u, pw, g8, t4);
            }
            mma3_steps<2>(ya, ah, al, bh, bl, pw);
        }
        if (k0 < kw) {
            unsigned ah[1][4], al[1][4], bh[1][NJ][2], bl[1][NJ][2];
            wfrag(k0, ah[0], al[0]);
            frag_b(bh[0], bl[0], sX, k0, pw, g8, t4);
            mma3_steps<1>(ya, ah, al, bh, bl, pw);
        }
        if (has_s) {
            // + exp(cs_t)·(C_t · S_{c−1})
            float sa4[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sa4[j][e] = 0.0f;
            const float* c0r = sC + r0 * NC;
            const float* c1r = sC + r1 * NC;
            for (int kk = 0; kk < N; kk += 16) {         // N % 16 == 0
                unsigned ah[2][4], al[2][4], bh[2][NJ][2], bl[2][NJ][2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int k = kk + 8 * u + t4;
                    split_a(c0r[k], c1r[k], c0r[k + 4], c1r[k + 4], ah[u],
                            al[u]);
                    frag_b(bh[u], bl[u], sS, kk + 8 * u, pw, g8, t4);
                }
                mma3_steps<2>(sa4, ah, al, bh, bl, pw);
            }
            const float e0 = expf(cs0), e1 = expf(cs1);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                ya[j][0] = fmaf(e0, sa4[j][0], ya[j][0]);
                ya[j][1] = fmaf(e0, sa4[j][1], ya[j][1]);
                ya[j][2] = fmaf(e1, sa4[j][2], ya[j][2]);
                ya[j][3] = fmaf(e1, sa4[j][3], ya[j][3]);
            }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            if (8 * j >= pw) break;
            const int p = p0 + 8 * j + 2 * t4;
            if (r0 < valid)
                *reinterpret_cast<float2*>(
                    y + ((row0 + r0) * H + h) * P + p) =
                    make_float2(ya[j][0], ya[j][1]);
            if (r1 < valid)
                *reinterpret_cast<float2*>(
                    y + ((row0 + r1) * H + h) * P + p) =
                    make_float2(ya[j][2], ya[j][3]);
        }
    }
}

// Shared memory of pass 1's roles (the larger) and of pass 3, in bytes;
// kernels/ssd_scan.py smem_bytes counts the same (repro_ssd_smem_bytes
// reports these to the card's test of that).
int smem_pass1(int L, int N) {
    const int states = 4 * (L * (N + 8) + 2 * L * PS + MAX_HT * L + MAX_HT);
    const int cb = 4 * 2 * L * KSS;
    return states > cb ? states : cb;
}

int smem_pass3(int L, int N) {
    return 4 * (L * (L + 4) + 3 * MAX_HT * L + 2 * L * PS + 2 * N * PS
                + L * (N + 4));
}

template <typename K>
int opt_in(K kernel, int bytes, int (&opted)[kMaxDevices], int dev) {
    if (bytes <= opted[dev]) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = bytes;
    return 0;
}

template <int L>
int launch_chunked(const float* x, const float* dt, const float* A,
                   const float* B, const float* C, const float* h0,
                   float* y, float* s_out, float* scratch, int Bt, int T,
                   int H, int G, int N, int P, int ht, cudaStream_t stream) {
    static int opted1[kMaxDevices] = {}, opted3[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    const int nc = (T + L - 1) / L;
    const int rep = H / G, nht = (rep + ht - 1) / ht;
    const int npt = (P + PT - 1) / PT;
    const long long tiles = static_cast<long long>(G) * nht * npt;
    if (nc > 65535 || Bt > 65535 || tiles + G > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long NP = static_cast<long long>(N) * P;
    float* states = scratch;
    float* cs = states + (nc > 1 ? static_cast<long long>(Bt) * nc * H * NP
                                 : 0);
    float* cb = cs + static_cast<long long>(Bt) * nc * H * L;
    const int b1 = smem_pass1(L, N), b3 = smem_pass3(L, N);
    int rc = opt_in(ssd_chunk_state<L>, b1, opted1, dev);
    if (rc) return rc;
    rc = opt_in(ssd_chunk_out<L>, b3, opted3, dev);
    if (rc) return rc;
    ssd_chunk_state<L><<<dim3(static_cast<unsigned>(tiles + G), nc, Bt),
                         Block<L>::NT, b1, stream>>>(
        x, dt, A, B, C, h0, states, s_out, cs, cb, T, H, G, N, P, nc, ht,
        nht, npt);
    if (nc > 1) {
        const int np4 = static_cast<int>(NP / 4);
        ssd_state_pass<<<dim3((np4 + STATE_THREADS - 1) / STATE_THREADS, H,
                              Bt), STATE_THREADS, 0, stream>>>(
            states, cs, h0, s_out, H, np4, nc, L);
    }
    ssd_chunk_out<L><<<dim3(static_cast<unsigned>(tiles), nc, Bt),
                       Block<L>::NT, b3, stream>>>(
        x, dt, C, h0, states, cs, cb, y, T, H, G, N, P, nc, ht, nht, npt);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: at least kernels/ssd_scan.py scratch_floats(...) floats, 16-byte
// aligned; heads in [1, REPRO_SSD_HEADS].
extern "C" int repro_ssd_scan_f32(const float* x, const float* dt,
                                  const float* A, const float* B,
                                  const float* C, const float* h0, float* y,
                                  float* s_out, float* scratch, int Bt,
                                  int T, int H, int G, int N, int P,
                                  int heads, cudaStream_t stream) {
    if (Bt <= 0 || H <= 0) return 0;
    if (T < 0 || G <= 0 || H % G != 0 || N <= 0 || N % 16 != 0 || N > 128
        || P <= 0 || P % 16 != 0 || heads < 1 || heads > MAX_HT)
        return static_cast<int>(cudaErrorInvalidValue);
    if (T == 0) {               // no token: the final state is h0 (or 0)
        if (Bt > 65535) return static_cast<int>(cudaErrorInvalidValue);
        const int np4 = N * P / 4;
        ssd_state_pass<<<dim3((np4 + STATE_THREADS - 1) / STATE_THREADS, H,
                              Bt), STATE_THREADS, 0, stream>>>(
            scratch, scratch, h0, s_out, H, np4, 0, 1);
        return static_cast<int>(cudaGetLastError());
    }
    return launch_chunked<REPRO_SSD_CHUNK>(x, dt, A, B, C, h0, y, s_out,
                                           scratch, Bt, T, H, G, N, P, heads,
                                           stream);
}

// Bytes of shared memory a block of pass 1 (which = 1) or pass 3 (which =
// 3) takes at state width N; -1 for another pass.
extern "C" int repro_ssd_smem_bytes(int N, int which) {
    return which == 1   ? smem_pass1(REPRO_SSD_CHUNK, N)
           : which == 3 ? smem_pass3(REPRO_SSD_CHUNK, N)
                        : -1;
}
