// Integer-pel motion search: SAD sweep + first-minimum argmin per block.
//
// Replaces the TPU kernel homerhevc_tpu/ops/me_pallas.py (_me_kernel via
// integer_me_pallas). For every B x B block of `cur`, the minimum over the
// (2S+1)^2 window offsets of SAD + mvcost[o], where o enumerates (dy, dx) in
// dy-major raster order; on equal cost the lower o wins (the reference's
// strict-less sweep, me_pallas.py:51-53).
//
// Design (sm_90a, a first correct kernel — no wgmma/TMA yet): one CTA per
// block. The block and its (B + 2S)^2 reference window are staged once in
// shared memory (int32 words, so neighbouring threads read neighbouring
// banks); each thread sweeps a strided subset of the offsets, keeps its own
// first minimum, and the CTA reduces (cost, offset) lexicographically with
// warp shuffles. Bound on this card: shared-memory loads (two per absolute
// difference, B*B*(2S+1)^2 per block), not device memory — each reference
// pixel is read from device memory about ((B + 2S) / B)^2 times in all.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 0x7fffffff;

__device__ __forceinline__ void lexmin(int& c, int& i, int c2, int i2) {
    if (c2 < c || (c2 == c && i2 < i)) {
        c = c2;
        i = i2;
    }
}

__device__ __forceinline__ void warp_lexmin(int& c, int& i) {
    for (int off = 16; off > 0; off >>= 1) {
        int c2 = __shfl_down_sync(0xffffffffu, c, off);
        int i2 = __shfl_down_sync(0xffffffffu, i, off);
        lexmin(c, i, c2, i2);
    }
}

__global__ void __launch_bounds__(kThreads)
me_sad_kernel(const int16_t* __restrict__ cur, const int16_t* __restrict__ ref,
              const int32_t* __restrict__ mvcost, int32_t* __restrict__ cost_out,
              int32_t* __restrict__ idx_out, int W, int Wp, int B, int S,
              int pad) {
    extern __shared__ int32_t smem[];
    __shared__ int red_c[kThreads / 32];
    __shared__ int red_i[kThreads / 32];
    const int n = 2 * S + 1;
    const int L = B + 2 * S;
    int32_t* win = smem;          // (L, L) reference window
    int32_t* blk = smem + L * L;  // (B, B) current block
    const int nbx = gridDim.x;
    const int y0 = blockIdx.y * B;
    const int x0 = blockIdx.x * B;
    const int ry0 = pad - S + y0;
    const int rx0 = pad - S + x0;

    for (int t = threadIdx.x; t < L * L; t += blockDim.x) {
        const int yy = t / L, xx = t - yy * L;
        win[t] = ref[(size_t)(ry0 + yy) * Wp + rx0 + xx];
    }
    for (int t = threadIdx.x; t < B * B; t += blockDim.x) {
        const int yy = t / B, xx = t - yy * B;
        blk[t] = cur[(size_t)(y0 + yy) * W + x0 + xx];
    }
    __syncthreads();

    int best_c = kBig, best_o = kBig;
    for (int o = threadIdx.x; o < n * n; o += blockDim.x) {
        const int dy = o / n, dx = o - dy * n;
        int sad = 0;
        for (int yy = 0; yy < B; ++yy) {
            const int32_t* wr = win + (dy + yy) * L + dx;
            const int32_t* cr = blk + yy * B;
            for (int xx = 0; xx < B; ++xx) sad += abs(cr[xx] - wr[xx]);
        }
        const int c = sad + mvcost[o];
        if (c < best_c) {  // offsets rise within a thread: strict keeps first
            best_c = c;
            best_o = o;
        }
    }

    warp_lexmin(best_c, best_o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) {
        red_c[wid] = best_c;
        red_i[wid] = best_o;
    }
    __syncthreads();
    if (wid == 0) {
        const int nw = blockDim.x >> 5;
        best_c = lane < nw ? red_c[lane] : kBig;
        best_o = lane < nw ? red_i[lane] : kBig;
        warp_lexmin(best_c, best_o);
        if (lane == 0) {
            cost_out[blockIdx.y * nbx + blockIdx.x] = best_c;
            idx_out[blockIdx.y * nbx + blockIdx.x] = best_o;
        }
    }
}

}  // namespace

extern "C" int me_sad_launch(const void* cur, const void* ref,
                             const void* mvcost, void* cost, void* idx, int H,
                             int W, int Wp, int B, int S, int pad,
                             void* stream) {
    const int L = B + 2 * S;
    const size_t smem = (size_t)(L * L + B * B) * sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            me_sad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(W / B, H / B);
    me_sad_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const int16_t*)cur, (const int16_t*)ref, (const int32_t*)mvcost,
        (int32_t*)cost, (int32_t*)idx, W, Wp, B, S, pad);
    return (int)cudaGetLastError();
}

extern "C" const char* me_sad_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
