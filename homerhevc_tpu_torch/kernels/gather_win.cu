// Batched per-block window gather.
//
// Replaces the TPU kernel homerhevc_tpu/ops/gather_pallas.py (_gw_kernel via
// gather_windows_grid): for each block b, the (G, G) window of a padded
// int16 plane at absolute top-left (by[b], bx[b]), written as (nb, G, G);
// for P planes of one shape with the same starts (the two chroma planes),
// (P, nb, G, G) from one launch. Starts follow lax.dynamic_slice: a negative
// start counts from the end, and the start is then clamped to [0, Hp - G] x
// [0, Wp - G], so the kernel agrees with the plain version (and the JAX CPU
// path) at any start.
//
// What bounds it on an H100: bytes, in principle (the distinct plane
// samples the windows cover read once, every window written once: 0.6-3.3
// us of HBM time at the 720p sites), but a copy this small is over before
// the memory system is busy. What it waits for is the launch, one chain of
// dependent latencies per CTA (its starts, the samples from L2, the
// stores) and, for the small windows, the grid itself: one CTA per window
// gave the CU-8 chroma pair (G 7, nb 15,360 x 2) 30,720 CTAs of 256
// threads for 49 samples each, and that empty grid alone took 0.0193 of
// the copy's 0.0199 ms. So the launcher picks one of two paths by G:
//  * the span path, where a window is small against a CTA (G 7, 11, 14 and
//    17: the CU-8 sites and the CU-16 chroma pair). A CTA owns W
//    consecutive windows of the flattened (P * nb) output: one contiguous
//    span of W * G * G samples. W is a multiple of 8, so a span starts on
//    a 16-byte boundary for any G, and span_width(G) sizes it so the grid
//    is one wave of the card, not one CTA per window (G 7: 768 CTAs). The
//    CTA puts its W window sources (clamped start, plane) in shared memory
//    first: the block loads its own indices, where the TPU kernel
//    prefetched scalars. Each thread then loads samples t, t + 256, ... of
//    the span from L2, each mapped to (window, yy, xx) by a multiply-high
//    and a shift (G is a template parameter), all of them before its first
//    store; neighbouring lanes take neighbouring samples, so a warp's loads
//    touch few rows. The samples go to shared memory and, after a barrier,
//    out as 16-byte vector stores; only the last span's ragged tail (where
//    P * nb is not a multiple of 8) goes sample by sample. A version that
//    kept each thread's 8 samples in registers and stored them directly,
//    without the shared-memory stage, was 9-80% slower at the same W (its
//    lanes load 8 samples apart); tools/gather_variants.cu keeps it;
//  * the window path everywhere else (G 19-73: the CU-32 and CU-64 sites,
//    the CU-16 luma and refine windows), where a window already
//    holds 361-5,329 samples: one CTA per window and plane, all resident at
//    once, a thread per sample, 2-byte loads and stores, G a template
//    parameter for the P stages' sizes (so t / G is a multiply and a shift,
//    the loops unroll and every load of a thread is in flight before its
//    first store), any other G in the generic kernel. Before the span
//    path it ran at every G; it stays callable at every G as the yardstick
//    (gather_win_window_launch). At G 19, 22 and 25 the span path tied or
//    lost to it (0.0030 against 0.0030, 0.0045 against 0.0046, 0.0055
//    against 0.0053 ms), so those G keep it.
// Two other designs of the window path with wider stores did not beat it
// (a warp per window row with 4-byte stores: slower; the window staged in
// shared memory and written as 16-byte vectors: equal at G 41, slower for
// the chroma pair); tools/gather_variants.cu holds them too.
// tools/kernel_report.py times them, and `--sweep` times the span path at
// every W it takes at each small-window site: the numbers above (H100 80GB
// HBM3, 700 W).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 4;
// The most windows a span may hold; its sources take 8 bytes each of
// shared memory.
constexpr int kMaxSpan = 256;
// The span path gives a thread at most this many 8-sample chunks.
constexpr int kMaxChunks = 4;

struct Args {
    const int16_t* plane[kMaxPlanes];  // P planes, each (Hp, Wp)
    const int32_t* by;                 // (nb,)
    const int32_t* bx;
    int16_t* out;                      // (P, nb, G, G)
    int nb, Hp, Wp, G, nplanes;
};

// Top-left sample of block b's window in plane p.
__device__ __forceinline__ const int16_t* window_src(const Args& a, int G,
                                                     int p, int b) {
    // lax.dynamic_slice semantics: a negative start counts from the end,
    // then the start is clamped so the window lies inside the plane
    const int ys = a.by[b], xs = a.bx[b];
    const int yb = ys < 0 ? ys + a.Hp : ys;
    const int xb = xs < 0 ? xs + a.Wp : xs;
    const int y0 = min(max(yb, 0), a.Hp - G);
    const int x0 = min(max(xb, 0), a.Wp - G);
    // picked by comparisons: indexing the parameter array with a variable
    // would move the whole argument block to local memory
    const int16_t* plane = a.plane[0];
    if (p == 1) plane = a.plane[1];
    if (p == 2) plane = a.plane[2];
    if (p == 3) plane = a.plane[3];
    return plane + (size_t)y0 * a.Wp + x0;
}

// The window path's CTA: window blockIdx.x of plane blockIdx.y.
__device__ __forceinline__ void locate(const Args& a, int G,
                                       const int16_t*& src, int16_t*& dst) {
    const int b = blockIdx.x;
    src = window_src(a, G, blockIdx.y, b);
    dst = a.out + ((size_t)blockIdx.y * a.nb + b) * (G * G);
}

template <int G>
__global__ void __launch_bounds__(kThreads) gather_kernel(Args a) {
    constexpr int kIter = (G * G + kThreads - 1) / kThreads;
    const int16_t* src;
    int16_t* dst;
    locate(a, G, src, dst);
    int16_t v[kIter];
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
        const int t = threadIdx.x + i * kThreads;
        const int yy = t / G, xx = t - yy * G;
        v[i] = t < G * G ? src[(size_t)yy * a.Wp + xx] : (int16_t)0;
    }
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
        const int t = threadIdx.x + i * kThreads;
        if (t < G * G) dst[t] = v[i];
    }
}

// Any G: a thread per sample, G * G / 256 rounds.
__global__ void __launch_bounds__(kThreads) gather_generic_kernel(Args a) {
    const int G = a.G;
    const int16_t* src;
    int16_t* dst;
    locate(a, G, src, dst);
    for (int t = threadIdx.x; t < G * G; t += blockDim.x) {
        const int yy = t / G, xx = t - yy * G;
        dst[t] = src[(size_t)yy * a.Wp + xx];
    }
}

// The span path: CTA c writes windows [c * W, c * W + W) of the flattened
// (P * nb) output. Thread t loads samples t, t + 256, ... (8 K of them at
// most) of the span, neighbouring lanes on neighbouring samples, so a warp's
// loads touch few rows of the plane; writes them to shared memory; and
// after a barrier moves the span out as 16-byte vectors, 8-sample chunks t,
// t + 256, ...
template <int G, int K>
__global__ void __launch_bounds__(kThreads) gather_span_kernel(Args a, int W) {
    constexpr int kGG = G * G;
    __shared__ const int16_t* src[kMaxSpan];
    __shared__ __align__(16) uint16_t stage[K * kThreads * 8];
    const int f0 = blockIdx.x * W;
    const int nw = min(W, a.nplanes * a.nb - f0);
    for (int w = threadIdx.x; w < nw; w += kThreads) {
        const int p = (f0 + w) / a.nb;
        src[w] = window_src(a, G, p, f0 + w - p * a.nb);
    }
    __syncthreads();
    const unsigned n = nw * kGG;               // samples in this span
    uint16_t v[8 * K];
#pragma unroll
    for (int i = 0; i < 8 * K; ++i) {
        const unsigned s = threadIdx.x + i * kThreads;
        v[i] = 0;
        if (s < n) {
            const unsigned w = s / kGG, r = s - w * kGG;
            const unsigned yy = r / G, xx = r - yy * G;
            v[i] = (uint16_t)__ldg(src[w] + (int)yy * a.Wp + (int)xx);
        }
    }
#pragma unroll
    for (int i = 0; i < 8 * K; ++i) stage[threadIdx.x + i * kThreads] = v[i];
    __syncthreads();
    int16_t* dst = a.out + (size_t)f0 * kGG;   // 16-byte aligned: W % 8 == 0
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const unsigned s0 = 8 * (threadIdx.x + i * kThreads);
        if (s0 + 8 <= n) {
            *reinterpret_cast<uint4*>(dst + s0) =
                *reinterpret_cast<const uint4*>(stage + s0);
        } else if (s0 < n) {                   // the ragged tail
            for (unsigned j = 0; s0 + j < n; ++j)
                dst[s0 + j] = (int16_t)stage[s0 + j];
        }
    }
}

// Same grid and CTA size as a launch of either path, no work: what a
// launch of that shape costs.
__global__ void gather_floor_kernel() {}

// The span path's width W at G (windows per CTA), 0 where G takes the
// window path: from tools/kernel_report.py --sweep on an H100 at the 720p
// sites. The grid should fit one wave: K = 4 chunks a thread takes 48
// registers, so 5 CTAs of 256 threads fit an SM (660 CTAs on the card);
// K <= 2, 32 registers and 8 CTAs (1,056). At G 19, 22 and 25 the span path
// tied or lost to the window path (2,888-5,000 samples a CTA already), so
// those G keep the window path.
int span_width(int G) {
    switch (G) {
    case 7: return 40;     // CU 8 chroma pair: 1,960 samples a CTA, 768 CTAs
    case 11: return 16;    // CU 16 chroma pair: 1,936, 460 CTAs
    case 14: return 16;    // CU 8 refine: 3,136 (K 2), 960 CTAs
    case 17: return 24;    // CU 8 luma: 6,936 (K 4), 640 CTAs
    default: return 0;
    }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int G>
void span_launch(const Args& a, int W, int K, cudaStream_t st) {
    const int grid = ceil_div(a.nplanes * a.nb, W);
    if (K == 1)
        gather_span_kernel<G, 1><<<grid, kThreads, 0, st>>>(a, W);
    else if (K == 2)
        gather_span_kernel<G, 2><<<grid, kThreads, 0, st>>>(a, W);
    else
        gather_span_kernel<G, kMaxChunks><<<grid, kThreads, 0, st>>>(a, W);
}

Args make_args(const void* p0, const void* p1, const void* p2,
               const void* p3, int nplanes, const void* by, const void* bx,
               void* out, int nb, int Hp, int Wp, int G) {
    return Args{{(const int16_t*)p0, (const int16_t*)p1, (const int16_t*)p2,
                 (const int16_t*)p3},
                (const int32_t*)by, (const int32_t*)bx, (int16_t*)out,
                nb, Hp, Wp, G, nplanes};
}

bool bad_args(int nplanes, int Hp, int Wp, int G) {
    return nplanes < 1 || nplanes > kMaxPlanes || G < 1 || G > Hp || G > Wp;
}

// The window path; `templated` = false always takes the any-G kernel.
int window_launch(const Args& a, cudaStream_t st, bool templated) {
    const dim3 grid(a.nb, a.nplanes);
    switch (templated ? a.G : 0) {
#define GATHER_CASE(g) \
    case g: gather_kernel<g><<<grid, kThreads, 0, st>>>(a); break;
        GATHER_CASE(41) GATHER_CASE(19)      // CU 32: luma, chroma pair
        GATHER_CASE(25) GATHER_CASE(11)      // CU 16: luma, chroma pair
        GATHER_CASE(38) GATHER_CASE(22)      // hierarchical ME refine, 32 / 16
        GATHER_CASE(73) GATHER_CASE(35)      // CU 64: luma, chroma pair
        GATHER_CASE(70)                      // hierarchical ME refine, 64
        GATHER_CASE(17) GATHER_CASE(14)      // CU 8: luma, refine
#undef GATHER_CASE
    default: gather_generic_kernel<<<grid, kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

// The span path at W windows a CTA; refuses a W the kernel cannot take
// (not a multiple of 8, above kMaxSpan or kMaxChunks chunks a thread), a G
// without a span instance, or an output that is not 16-byte aligned.
int span_path(const Args& a, int W, cudaStream_t st) {
    const int K = ceil_div(W * a.G * a.G, 8 * kThreads);
    if (W < 8 || W % 8 || W > kMaxSpan || K > kMaxChunks ||
        reinterpret_cast<uintptr_t>(a.out) % 16)
        return (int)cudaErrorInvalidValue;
    switch (a.G) {
#define SPAN_CASE(g) case g: span_launch<g>(a, W, K, st); break;
        SPAN_CASE(7) SPAN_CASE(11) SPAN_CASE(14) SPAN_CASE(17)
        // the launcher takes the window path at these; kept for the sweep
        SPAN_CASE(19) SPAN_CASE(22) SPAN_CASE(25)
#undef SPAN_CASE
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The port's launcher: the span path where span_width(G) names a width,
// else the window path.
extern "C" int gather_win_launch(const void* p0, const void* p1,
                                 const void* p2, const void* p3, int nplanes,
                                 const void* by, const void* bx, void* out,
                                 int nb, int Hp, int Wp, int G, void* stream) {
    if (bad_args(nplanes, Hp, Wp, G)) return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    const Args a = make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp,
                             Wp, G);
    const int W = span_width(G);
    return W ? span_path(a, W, (cudaStream_t)stream)
             : window_launch(a, (cudaStream_t)stream, true);
}

// The window path at any G (the earlier kernel at every site): a yardstick.
extern "C" int gather_win_window_launch(const void* p0, const void* p1,
                                        const void* p2, const void* p3,
                                        int nplanes, const void* by,
                                        const void* bx, void* out, int nb,
                                        int Hp, int Wp, int G, void* stream) {
    if (bad_args(nplanes, Hp, Wp, G)) return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    return window_launch(make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb,
                                   Hp, Wp, G),
                         (cudaStream_t)stream, true);
}

// The any-G kernel at any G, to time beside the template instances.
extern "C" int gather_win_generic_launch(const void* p0, const void* p1,
                                         const void* p2, const void* p3,
                                         int nplanes, const void* by,
                                         const void* bx, void* out, int nb,
                                         int Hp, int Wp, int G,
                                         void* stream) {
    if (bad_args(nplanes, Hp, Wp, G)) return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    return window_launch(make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb,
                                   Hp, Wp, G),
                         (cudaStream_t)stream, false);
}

// The span path at a given width W (to sweep W on the card).
extern "C" int gather_win_span_launch(const void* p0, const void* p1,
                                      const void* p2, const void* p3,
                                      int nplanes, const void* by,
                                      const void* bx, void* out, int nb,
                                      int Hp, int Wp, int G, int W,
                                      void* stream) {
    if (bad_args(nplanes, Hp, Wp, G)) return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    return span_path(make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp,
                               Wp, G),
                     W, (cudaStream_t)stream);
}

// Windows per CTA that gather_win_launch takes at G (0: the window path).
extern "C" int gather_win_span_width(int G) { return span_width(G); }

// An empty kernel with the grid and CTA size of a launch at (nb, nplanes,
// G): W > 0, a span launch of W windows a CTA; W = 0, the window path's
// grid; W < 0, the grid gather_win_launch takes at G.
extern "C" int gather_win_floor_launch(int nb, int nplanes, int G, int W,
                                       void* stream) {
    if (nb == 0) return 0;
    if (W < 0) W = span_width(G);
    const dim3 grid = W ? dim3(ceil_div(nb * nplanes, W)) : dim3(nb, nplanes);
    gather_floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* gather_win_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
