// Throughput of two integer instructions on one GPU: vabsdiff4 with
// accumulate (what kernels/me_sad.cu is made of) and mad.lo.u32 (a
// full-rate integer instruction, as the yardstick). Every thread runs eight
// independent chains of the instruction, 64 instructions per loop
// iteration; tools/kernel_report.py builds this file, times a launch and
// prints lanes per clock and SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int OP>
__global__ void rate_kernel(uint32_t* out, int iters, uint32_t seed) {
    uint32_t a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 8 + i;
    const uint32_t b = seed + threadIdx.x, c = seed * 3 + blockIdx.x;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (OP == 0)
                    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                        : "+r"(a[i])
                        : "r"(b), "r"(c));
                else
                    asm("mad.lo.u32 %0, %1, %2, %0;"
                        : "+r"(a[i])
                        : "r"(b), "r"(c));
            }
        }
    }
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) s ^= a[i];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// op 0: vabsdiff4 with accumulate; op 1: mad.lo.u32. `out` holds blocks *
// threads words. Each thread runs 64 * iters instructions of the kind.
extern "C" int int_rate_launch(int op, void* out, int blocks, int threads,
                               int iters, void* stream) {
    if (op == 0)
        rate_kernel<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (uint32_t*)out, iters, 12345u);
    else
        rate_kernel<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (uint32_t*)out, iters, 12345u);
    return (int)cudaGetLastError();
}
