// SAME-padded K x K max pool over NHWC float32, with an optional
// activation on the pooled value.
//
// Replaces the Pallas kernel of src/repro/kernels/maxpool.py (`maxpool2d`,
// `_pool_kernel`), which pads the image with finfo.min into a halo'd strip
// tensor and reduces K^2 shifted slices. Here taps outside the image count
// as -FLT_MAX (finfo.min) without a padded copy, and the max propagates
// NaN (max_nan), as jnp.maximum does, so the result is bit-equal to the
// plain version (a max is exact in any order of the taps).
//
// Bound on this card: bytes (one compare per tap, a tap a few bytes).
// Two routes, chosen with their tile and grid by kernels/maxpool.py
// `_plan`, each in a float4 variant (C % 4 == 0, both pointers 16-byte
// aligned) and a float one; a vector is V, CV of them a pixel:
//
// * overlap (stride < k: SPPF's 5x5/s1, yolov3-tiny's 2x2/s1). A window
//   shares taps with its neighbours, so a block stages its halo'd input
//   tile once in shared memory by cp.async ((th-1)·s + k rows by
//   (tw-1)·s + k columns by a slab of cs vectors; taps outside the image
//   written as -FLT_MAX) and takes the max separably: along W over k taps
//   into a per-thread column of row maxima, then along H over k of those,
//   2k compares an output in place of k². Each input byte comes from
//   device memory once and from L2 about (th + k - 1)/th times. Thread
//   (tx, ty) of a (cs, tw) block owns output column ow0 + ty and vector
//   slab·cs + tx; the grid is (column tiles × slabs, row tiles, N), so
//   a block finds its tile with one division, before any loop.
// * disjoint (stride >= k: the 2x2/s2 downsamples). Every input byte
//   belongs to at most one window: no shared memory. A grid of at most one
//   wave (kResident blocks an SM, which __launch_bounds__ holds) walks the
//   output vectors grid-stride, sized so that every thread takes the same
//   number of rounds; each thread keeps its position as a mixed-radix
//   counter (n, oh, ow, cv) stepped by the grid's stride with carries, so
//   the loop divides nothing. Each round takes two outputs, loading all
//   their taps (read once: ld.global.nc, not allocated in L1) before
//   reducing any, and stores with a streaming store (st.global.cs,
//   evict-first). k == 2 is compiled with its taps unrolled; any other k
//   loops. This route also takes a window whose overlap tile would not
//   fit 48 KB of shared memory, or whose grid would not (`_plan`): it is
//   correct for any (k, stride).
//
// The activation is a template argument, chosen once on the host, so
// apply_act's switch folds away. Indices are int: the wrapper's
// check_operand refuses an operand of 2^31 or more elements.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // the most threads a block (kernels/maxpool.py)
constexpr int kResident = 6;    // disjoint blocks an SM (maxpool.py RESIDENT)
enum Route : int { ROUTE_OVERLAP = 0, ROUTE_DISJOINT = 1 };

struct Shape {
    int N, H, W, CV, k, s, Ho, Wo, pt, pl;
};

__device__ __forceinline__ float vmax(float a, float b) {
    return max_nan(a, b);
}
__device__ __forceinline__ float4 vmax(float4 a, float4 b) {
    return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y),
                       max_nan(a.z, b.z), max_nan(a.w, b.w));
}

template <typename V> __device__ __forceinline__ V lowest();
template <> __device__ __forceinline__ float lowest<float>() {
    return -FLT_MAX;
}
template <> __device__ __forceinline__ float4 lowest<float4>() {
    return make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
}

template <int A>
__device__ __forceinline__ float act(float v) { return apply_act(v, A); }
template <int A>
__device__ __forceinline__ float4 act(float4 v) {
    return make_float4(apply_act(v.x, A), apply_act(v.y, A),
                       apply_act(v.z, A), apply_act(v.w, A));
}

// cp.async of one vector into shared memory (4 bytes by .ca, 16 by .cg).
__device__ __forceinline__ void stage(float* s, const float* g) {
    cp_async4(s, g, true);
}
__device__ __forceinline__ void stage(float4* s, const float4* g) {
    cp_async16(s, g, true);
}

// A load of data read once: the non-coherent path, no L1 line kept.
__device__ __forceinline__ float load_once(const float* p) {
    float v;
    asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n"
                 : "=f"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ float4 load_once(const float4* p) {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, "
                 "[%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
}

// ---------------------------------------------------------------- overlap

template <typename V, int A>
__global__ void __launch_bounds__(kThreads)
pool_overlap_kernel(const V* __restrict__ x, V* __restrict__ y,
                    const Shape sh, int th, int slabs) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int cs = blockDim.x, tw = blockDim.y;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int k = sh.k, s = sh.s;
    const int wt = blockIdx.x / slabs;            // the block's one division
    const int cv = (blockIdx.x - wt * slabs) * cs + tx;
    const int n = blockIdx.z;
    const int oh0 = blockIdx.y * th, ow0 = wt * tw;
    const int rows_out = min(th, sh.Ho - oh0);
    const int cols_out = min(tw, sh.Wo - ow0);
    const int rows = (rows_out - 1) * s + k;      // input rows this tile needs
    const int cols = (cols_out - 1) * s + k;
    const int pitch = (tw - 1) * s + k;           // a tile row, in pixels
    V* tile = reinterpret_cast<V*>(smem_raw);     // [rows][pitch][cs]
    V* hmax = tile + ((th - 1) * s + k) * pitch * cs;   // [rows][tw][cs]
    const bool live = cv < sh.CV;
    const int ih0 = oh0 * s - sh.pt, iw0 = ow0 * s - sh.pl;
    if (live) {
        for (int r = 0; r < rows; ++r) {
            const int ih = ih0 + r;
            const bool row_in = ih >= 0 && ih < sh.H;
            V* dst = tile + r * pitch * cs + tx;
            for (int c = ty; c < cols; c += tw) {
                const int iw = iw0 + c;
                if (row_in && iw >= 0 && iw < sh.W)
                    stage(dst + c * cs,
                          x + ((n * sh.H + ih) * sh.W + iw) * sh.CV + cv);
                else
                    dst[c * cs] = lowest<V>();
            }
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // From here each thread reads the tile and its own column of hmax:
    // no further barrier.
    if (!live || ty >= cols_out) return;
    for (int r = 0; r < rows; ++r) {
        const V* t = tile + (r * pitch + ty * s) * cs + tx;
        V m = t[0];
        for (int kw = 1; kw < k; ++kw) m = vmax(m, t[kw * cs]);
        hmax[(r * tw + ty) * cs + tx] = m;
    }
    const int row_step = tw * cs;
    V* out = y + ((n * sh.Ho + oh0) * sh.Wo + ow0 + ty) * sh.CV + cv;
    for (int i = 0; i < rows_out; ++i, out += sh.Wo * sh.CV) {
        const V* h = hmax + (i * s * tw + ty) * cs + tx;
        V m = h[0];
        for (int kh = 1; kh < k; ++kh) m = vmax(m, h[kh * row_step]);
        *out = act<A>(m);
    }
}

// --------------------------------------------------------------- disjoint

// An output vector's position, and the grid's stride in the same digits.
struct Pos {
    int n, oh, ow, cv;
};

__device__ __forceinline__ Pos unflatten(long long e, const Shape& sh) {
    Pos p;
    p.cv = static_cast<int>(e % sh.CV);
    e /= sh.CV;
    p.ow = static_cast<int>(e % sh.Wo);
    e /= sh.Wo;
    p.oh = static_cast<int>(e % sh.Ho);
    e /= sh.Ho;
    p.n = static_cast<int>(e < sh.N ? e : sh.N);
    return p;
}

// p += d, digit by digit: each digit plus its carry stays below twice its
// radix, so one conditional subtraction brings it back.
__device__ __forceinline__ void advance(Pos& p, const Pos& d,
                                        const Shape& sh) {
    p.cv += d.cv;
    int c = p.cv >= sh.CV;
    p.cv -= c ? sh.CV : 0;
    p.ow += d.ow + c;
    c = p.ow >= sh.Wo;
    p.ow -= c ? sh.Wo : 0;
    p.oh += d.oh + c;
    c = p.oh >= sh.Ho;
    p.oh -= c ? sh.Ho : 0;
    p.n += d.n + c;
}

// Tap (kh, kw) of the window at p: the input vector, or -FLT_MAX outside
// the image (the plain version's finfo.min padding).
template <typename V>
__device__ __forceinline__ V tap(const V* x, const Pos& p, const Shape& sh,
                                 int kh, int kw) {
    const int ih = p.oh * sh.s - sh.pt + kh;
    const int iw = p.ow * sh.s - sh.pl + kw;
    if (ih < 0 || ih >= sh.H || iw < 0 || iw >= sh.W) return lowest<V>();
    return load_once(x + ((p.n * sh.H + ih) * sh.W + iw) * sh.CV + p.cv);
}

// The window max at p: with KT > 0 (k == KT) its KT² taps are loaded
// into registers before the first compare.
template <typename V, int KT>
__device__ __forceinline__ void window(const V* x, const Pos& p,
                                       const Shape& sh, V (&t)[KT * KT]) {
#pragma unroll
    for (int kh = 0; kh < KT; ++kh)
#pragma unroll
        for (int kw = 0; kw < KT; ++kw) t[kh * KT + kw] = tap(x, p, sh, kh, kw);
}

template <typename V, int KT>
__device__ __forceinline__ V reduce(const V (&t)[KT * KT]) {
    V m = t[0];
#pragma unroll
    for (int i = 1; i < KT * KT; ++i) m = vmax(m, t[i]);
    return m;
}

template <typename V>
__device__ __forceinline__ V window_any(const V* x, const Pos& p,
                                        const Shape& sh) {
    V m = tap(x, p, sh, 0, 0);
    for (int kh = 0; kh < sh.k; ++kh)
        for (int kw = kh == 0; kw < sh.k; ++kw)
            m = vmax(m, tap(x, p, sh, kh, kw));
    return m;
}

template <typename V, int A, int KT>
__global__ void __launch_bounds__(kThreads, kResident)
pool_disjoint_kernel(const V* __restrict__ x, V* __restrict__ y,
                     const Shape sh) {
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    // the only divisions: a thread's first position and the stride
    Pos p = unflatten(e, sh);
    const Pos d = unflatten(step, sh);
    while (p.n < sh.N) {
        Pos q = p;
        advance(q, d, sh);
        if (q.n < sh.N) {
            V a, b;
            if constexpr (KT > 0) {
                V ta[KT * KT], tb[KT * KT];
                window<V, KT>(x, p, sh, ta);
                window<V, KT>(x, q, sh, tb);
                a = reduce<V, KT>(ta);
                b = reduce<V, KT>(tb);
            } else {
                a = window_any(x, p, sh);
                b = window_any(x, q, sh);
            }
            __stcs(y + e, act<A>(a));
            __stcs(y + e + step, act<A>(b));
        } else {
            V a;
            if constexpr (KT > 0) {
                V ta[KT * KT];
                window<V, KT>(x, p, sh, ta);
                a = reduce<V, KT>(ta);
            } else {
                a = window_any(x, p, sh);
            }
            __stcs(y + e, act<A>(a));
        }
        p = q;
        advance(p, d, sh);
        e += 2 * step;
    }
}

template <typename V, int A>
cudaError_t run(const void* xv, void* yv, const Shape& sh, int route,
                int th, int tw, int cs, int gx, int gy, int gz,
                cudaStream_t stream) {
    const V* x = static_cast<const V*>(xv);
    V* y = static_cast<V*>(yv);
    if (route == ROUTE_OVERLAP) {
        // kernels/maxpool.py `smem_bytes`: the tile and the row maxima
        const int rows = (th - 1) * sh.s + sh.k;
        const size_t smem = static_cast<size_t>(rows) *
                            ((tw - 1) * sh.s + sh.k + tw) * cs * sizeof(V);
        const int slabs = (sh.CV + cs - 1) / cs;
        pool_overlap_kernel<V, A><<<dim3(gx, gy, gz), dim3(cs, tw), smem,
                                    stream>>>(x, y, sh, th, slabs);
    } else if (route == ROUTE_DISJOINT) {
        if (sh.k == 2)
            pool_disjoint_kernel<V, A, 2><<<gx, kThreads, 0, stream>>>(x, y,
                                                                      sh);
        else
            pool_disjoint_kernel<V, A, 0><<<gx, kThreads, 0, stream>>>(x, y,
                                                                      sh);
    } else {
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

template <int A>
cudaError_t run_act(int vec, const void* x, void* y, const Shape& sh,
                    int route, int th, int tw, int cs, int gx, int gy,
                    int gz, cudaStream_t stream) {
    return vec ? run<float4, A>(x, y, sh, route, th, tw, cs, gx, gy, gz,
                                stream)
               : run<float, A>(x, y, sh, route, th, tw, cs, gx, gy, gz,
                               stream);
}

}  // namespace

// The launch's integers, in the order of kernels/maxpool.py `PoolArgs`:
// the shape, the SAME pads, the activation code, then `_plan`'s route,
// vector width, tile (th, tw, cs; the overlap route's) and grid. Read on
// the host before the launch, so one pointer stands for 19 arguments in
// the call from Python.
struct PoolArgs {
    int N, H, W, C, k, stride, Ho, Wo, pad_top, pad_left, act;
    int route, vec, th, tw, cs, gx, gy, gz;
};

extern "C" int repro_maxpool2d_nhwc_f32(const float* x, float* y,
                                        const PoolArgs* a,
                                        cudaStream_t stream) {
    const Shape sh{a->N, a->H, a->W, a->vec ? a->C / 4 : a->C, a->k,
                   a->stride, a->Ho, a->Wo, a->pad_top, a->pad_left};
    cudaError_t e;
#define REPRO_POOL_ACT(A)                                                   \
    case A:                                                                 \
        e = run_act<A>(a->vec, x, y, sh, a->route, a->th, a->tw, a->cs,     \
                       a->gx, a->gy, a->gz, stream);                        \
        break;
    switch (a->act) {
    REPRO_POOL_ACT(ACT_IDENTITY)
    REPRO_POOL_ACT(ACT_HARDSWISH)
    REPRO_POOL_ACT(ACT_LEAKY_RELU)
    REPRO_POOL_ACT(ACT_SILU)
    REPRO_POOL_ACT(ACT_RELU)
    REPRO_POOL_ACT(ACT_GELU)
    default: e = cudaErrorInvalidValue;
    }
#undef REPRO_POOL_ACT
    return static_cast<int>(e);
}
