// Batched per-block window gather.
//
// Replaces the TPU kernel homerhevc_tpu/ops/gather_pallas.py (_gw_kernel via
// gather_windows_grid): for each block b, the (G, G) window of a padded
// int16 plane at absolute top-left (by[b], bx[b]), written as (nb, G, G).
// Starts follow lax.dynamic_slice: a negative start counts from the end, and
// the start is then clamped to [0, Hp - G] x [0, Wp - G], so the kernel
// agrees with the plain version (and the JAX CPU path) at any start.
//
// Design (sm_90a, a first correct kernel): one CTA per block, threads copy
// the window row by row (neighbouring threads on neighbouring columns, so
// reads and writes coalesce). Pure data movement: bound by device-memory
// traffic, 2 * nb * G * G * 2 bytes per call (the windows of neighbouring
// blocks overlap, and the overlap is served from L2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_win_kernel(const int16_t* __restrict__ plane,
                  const int32_t* __restrict__ by,
                  const int32_t* __restrict__ bx, int16_t* __restrict__ out,
                  int Hp, int Wp, int G) {
    const int b = blockIdx.x;
    // lax.dynamic_slice semantics: a negative start counts from the end,
    // then the start is clamped so the window lies inside the plane
    const int yb = by[b] < 0 ? by[b] + Hp : by[b];
    const int xb = bx[b] < 0 ? bx[b] + Wp : bx[b];
    const int y0 = min(max(yb, 0), Hp - G);
    const int x0 = min(max(xb, 0), Wp - G);
    int16_t* o = out + (size_t)b * G * G;
    for (int t = threadIdx.x; t < G * G; t += blockDim.x) {
        const int yy = t / G, xx = t - yy * G;
        o[t] = plane[(size_t)(y0 + yy) * Wp + x0 + xx];
    }
}

}  // namespace

extern "C" int gather_win_launch(const void* plane, const void* by,
                                 const void* bx, void* out, int nb, int Hp,
                                 int Wp, int G, void* stream) {
    if (nb == 0) return 0;
    gather_win_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)plane, (const int32_t*)by, (const int32_t*)bx,
        (int16_t*)out, Hp, Wp, G);
    return (int)cudaGetLastError();
}

extern "C" const char* gather_win_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
