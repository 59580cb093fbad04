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
// What bounds it on an H100: bytes, in principle (each window read and
// written once, 2 * P * nb * G * G * 2 bytes: 6.2 MB, under 2 us of HBM time
// for the luma call), but a copy this small is over before the memory
// system is busy. What it really waits for is one chain of dependent
// latencies: launch, the block's start (by, bx), the window's samples, the
// stores. So the design shortens the chain rather than the byte count:
//  * G is a template parameter for the sizes the P stages use where that
//    beat the generic kernel on the card (CU 32: 41 luma, 19 chroma; CU 16:
//    25 and 11; CU 64: 73 and 35; CU 8: 17 luma; the hierarchical search's
//    refine windows 70, 38, 22 and 14), so t / G is a multiply and a shift,
//    the loops unroll and every load of a thread is in flight before its
//    first store; any other G takes the generic kernel (the CU-8 chroma pair,
//    G 7, among them: 30,720 CTAs, as long as their empty grid either way);
//  * one CTA per window and plane, all of them resident at once;
//  * a thread per sample, G*G/256 samples per thread, 2-byte loads and
//    stores, neighbouring threads on neighbouring samples.
// Two designs with wider stores were measured against this one and did not
// beat it (a warp per window row with 4-byte stores: slower; the window
// staged in shared memory and written as 16-byte vectors: equal at G 41,
// slower for the chroma pair). tools/gather_variants.cu holds them and
// tools/kernel_report.py times all three in one loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 4;

struct Args {
    const int16_t* plane[kMaxPlanes];  // P planes, each (Hp, Wp)
    const int32_t* by;                 // (nb,)
    const int32_t* bx;
    int16_t* out;                      // (P, nb, G, G)
    int nb, Hp, Wp, G;
};

// The CTA's source (top-left sample of its window) and destination.
__device__ __forceinline__ void locate(const Args& a, int G,
                                       const int16_t*& src, int16_t*& dst) {
    const int b = blockIdx.x;
    // lax.dynamic_slice semantics: a negative start counts from the end,
    // then the start is clamped so the window lies inside the plane
    const int ys = a.by[b], xs = a.bx[b];
    const int yb = ys < 0 ? ys + a.Hp : ys;
    const int xb = xs < 0 ? xs + a.Wp : xs;
    const int y0 = min(max(yb, 0), a.Hp - G);
    const int x0 = min(max(xb, 0), a.Wp - G);
    // picked by comparisons: indexing the parameter array with blockIdx.y
    // would move the whole argument block to local memory
    const int16_t* plane = a.plane[0];
    if (blockIdx.y == 1) plane = a.plane[1];
    if (blockIdx.y == 2) plane = a.plane[2];
    if (blockIdx.y == 3) plane = a.plane[3];
    src = plane + (size_t)y0 * a.Wp + x0;
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

// Same grid and CTA size, no work: what a launch of this shape costs.
__global__ void gather_floor_kernel() {}

}  // namespace

namespace {

// `templated` = false always takes the any-G kernel (a yardstick for timing).
int launch(const void* p0, const void* p1, const void* p2, const void* p3,
           int nplanes, const void* by, const void* bx, void* out, int nb,
           int Hp, int Wp, int G, void* stream, bool templated) {
    if (nplanes < 1 || nplanes > kMaxPlanes || G < 1 || G > Hp || G > Wp)
        return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    Args a{{(const int16_t*)p0, (const int16_t*)p1, (const int16_t*)p2,
            (const int16_t*)p3},
           (const int32_t*)by, (const int32_t*)bx, (int16_t*)out,
           nb, Hp, Wp, G};
    const dim3 grid(nb, nplanes);
    cudaStream_t st = (cudaStream_t)stream;
    switch (templated ? G : 0) {
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

}  // namespace

extern "C" int gather_win_launch(const void* p0, const void* p1,
                                 const void* p2, const void* p3, int nplanes,
                                 const void* by, const void* bx, void* out,
                                 int nb, int Hp, int Wp, int G, void* stream) {
    return launch(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp, Wp, G, stream,
                  true);
}

// The any-G kernel at any G, to time beside the template instances.
extern "C" int gather_win_generic_launch(const void* p0, const void* p1,
                                         const void* p2, const void* p3,
                                         int nplanes, const void* by,
                                         const void* bx, void* out, int nb,
                                         int Hp, int Wp, int G,
                                         void* stream) {
    return launch(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp, Wp, G, stream,
                  false);
}

// An empty kernel with gather_win_launch's grid and CTA size.
extern "C" int gather_win_floor_launch(int nb, int nplanes, void* stream) {
    if (nb == 0) return 0;
    gather_floor_kernel<<<dim3(nb, nplanes), kThreads, 0,
                          (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* gather_win_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
