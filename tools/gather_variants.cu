// Other designs of the gather, kept for measurement only:
// tools/kernel_report.py builds this file and times them beside the kernel
// the port ships (homerhevc_tpu_torch/kernels/gather_win.cu, whose Args,
// start rule and CTA size they share by including it). Nothing in the port
// calls them. Two of the window path (gather_variants_launch):
//   1 "rows": a warp per window row, every row of a warp in flight; a lane
//     loads the two samples of one aligned 4-byte word of the output row and
//     stores the word, and two more lanes store the ragged first and last
//     sample (the output row is only 2-byte aligned for odd G).
//   2 "staged": the window goes to shared memory sample by sample, and after
//     a barrier the (contiguous, G * G * 2 bytes) output window is written as
//     16-byte vectors, with the ragged head and tail sample by sample
//     (out + b * G * G is only 2-byte aligned for odd G).
// and one other design of the span path (gather_span_direct_launch):
//   3 "span, direct": as the span path, but thread t keeps the 8 samples of
//     chunks t, t + 256, ... in registers and stores each chunk as one
//     16-byte vector, with no shared-memory stage; a warp's lanes then load
//     samples 8 apart.
#include "../homerhevc_tpu_torch/kernels/gather_win.cu"

namespace {

constexpr int kWarps = kThreads / 32;

template <int G>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(Args a) {
    static_assert(G / 2 + 2 <= 32, "a window row must fit one warp");
    constexpr int kRows = (G + kWarps - 1) / kWarps;  // rows per warp
    const int16_t* src;
    int16_t* dst;
    locate(a, G, src, dst);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // Row r of the output starts at dst + r * G. With h = 1 where that is
    // not 4-byte aligned: lanes 0..nw-1 move the aligned words (samples
    // h + 2 * lane and the next), lane nw the last sample if one is left
    // over, and the lane after it the first sample if h = 1.
    uint32_t lo[kRows], hi[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = warp + i * kWarps;
        lo[i] = hi[i] = 0;
        if (r < G) {
            const uint16_t* s =
                reinterpret_cast<const uint16_t*>(src + (size_t)r * a.Wp);
            const int h =
                (int)((reinterpret_cast<uintptr_t>(dst + r * G) >> 1) & 1);
            const int nw = (G - h) >> 1, tail = (G - h) & 1;
            if (lane < nw) {
                lo[i] = s[h + 2 * lane];
                hi[i] = s[h + 2 * lane + 1];
            } else if (lane == nw && tail) {
                lo[i] = s[G - 1];
            } else if (lane == nw + tail && h) {
                lo[i] = s[0];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = warp + i * kWarps;
        if (r < G) {
            int16_t* d = dst + r * G;
            const int h = (int)((reinterpret_cast<uintptr_t>(d) >> 1) & 1);
            const int nw = (G - h) >> 1, tail = (G - h) & 1;
            if (lane < nw) {
                *reinterpret_cast<uint32_t*>(d + h + 2 * lane) =
                    lo[i] | (hi[i] << 16);
            } else if (lane == nw && tail) {
                d[G - 1] = (int16_t)lo[i];
            } else if (lane == nw + tail && h) {
                d[0] = (int16_t)lo[i];
            }
        }
    }
}

template <int G>
__global__ void __launch_bounds__(kThreads) gather_staged_kernel(Args a) {
    constexpr int kN = G * G;
    constexpr int kIter = (kN + kThreads - 1) / kThreads;
    __shared__ uint16_t win[kN];
    const int16_t* src;
    int16_t* dst;
    locate(a, G, src, dst);
    uint16_t v[kIter];
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
        const int t = threadIdx.x + i * kThreads;
        const int yy = t / G, xx = t - yy * G;
        v[i] = t < kN ? (uint16_t)src[(size_t)yy * a.Wp + xx] : (uint16_t)0;
    }
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
        const int t = threadIdx.x + i * kThreads;
        if (t < kN) win[t] = v[i];
    }
    __syncthreads();
    // head: samples before the first 16-byte boundary of the output window
    const int head =
        (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 1;
    const int nvec = (kN - head) / 8;
    for (int t = threadIdx.x; t < nvec; t += kThreads) {
        const uint16_t* s = win + head + 8 * t;
        uint4 q;
        q.x = s[0] | ((uint32_t)s[1] << 16);
        q.y = s[2] | ((uint32_t)s[3] << 16);
        q.z = s[4] | ((uint32_t)s[5] << 16);
        q.w = s[6] | ((uint32_t)s[7] << 16);
        *reinterpret_cast<uint4*>(dst + head + 8 * t) = q;
    }
    // ragged head and tail: at most 7 samples each
    const int tail0 = head + 8 * nvec;
    const int ragged = head + (kN - tail0);
    if ((int)threadIdx.x < ragged) {
        const int t = (int)threadIdx.x < head
                          ? (int)threadIdx.x
                          : tail0 + ((int)threadIdx.x - head);
        dst[t] = (int16_t)win[t];
    }
}

template <int G, int K>
__global__ void __launch_bounds__(kThreads)
    gather_span_direct_kernel(Args a, int W) {
    constexpr int kGG = G * G;
    __shared__ const int16_t* src[kMaxSpan];
    const int f0 = blockIdx.x * W;
    const int nw = min(W, a.nplanes * a.nb - f0);
    for (int w = threadIdx.x; w < nw; w += kThreads) {
        const int p = (f0 + w) / a.nb;
        src[w] = window_src(a, G, p, f0 + w - p * a.nb);
    }
    __syncthreads();
    const unsigned n = nw * kGG;               // samples in this span
    uint32_t v[K][4];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const unsigned s0 = 8 * (threadIdx.x + i * kThreads);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // unsigned, so the divisions by the constants G * G and G are
            // a multiply-high and a shift
            const unsigned s = s0 + j;
            uint32_t x = 0;
            if (s < n) {
                const unsigned w = s / kGG, r = s - w * kGG;
                const unsigned yy = r / G, xx = r - yy * G;
                x = (uint16_t)__ldg(src[w] + (int)yy * a.Wp + (int)xx);
            }
            if (j & 1)
                v[i][j >> 1] |= x << 16;
            else
                v[i][j >> 1] = x;
        }
    }
    int16_t* dst = a.out + (size_t)f0 * kGG;   // 16-byte aligned: W % 8 == 0
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const unsigned s0 = 8 * (threadIdx.x + i * kThreads);
        if (s0 + 8 <= n) {
            *reinterpret_cast<uint4*>(dst + s0) =
                make_uint4(v[i][0], v[i][1], v[i][2], v[i][3]);
        } else if (s0 < n) {                   // the ragged tail
#pragma unroll
            for (unsigned j = 0; j < 8; ++j)
                if (s0 + j < n)
                    dst[s0 + j] = (int16_t)(v[i][j >> 1] >> (16 * (j & 1)));
        }
    }
}

template <int G>
void span_direct(const Args& a, int W, cudaStream_t st) {
    const int grid = ceil_div(a.nplanes * a.nb, W);
    const int K = ceil_div(W * G * G, 8 * kThreads);
    if (K == 1)
        gather_span_direct_kernel<G, 1><<<grid, kThreads, 0, st>>>(a, W);
    else if (K == 2)
        gather_span_direct_kernel<G, 2><<<grid, kThreads, 0, st>>>(a, W);
    else
        gather_span_direct_kernel<G, kMaxChunks>
            <<<grid, kThreads, 0, st>>>(a, W);
}

}  // namespace

// which: 1 rows, 2 staged; G 41 or 19 only.
extern "C" int gather_variants_launch(const void* p0, const void* p1,
                                      const void* p2, const void* p3,
                                      int nplanes, const void* by,
                                      const void* bx, void* out, int nb,
                                      int Hp, int Wp, int G, int which,
                                      void* stream) {
    if (nplanes < 1 || nplanes > kMaxPlanes || (G != 41 && G != 19) ||
        G > Hp || G > Wp || which < 1 || which > 2 || nb == 0)
        return (int)cudaErrorInvalidValue;
    const Args a = make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp,
                             Wp, G);
    const dim3 grid(nb, nplanes);
    cudaStream_t st = (cudaStream_t)stream;
    if (which == 1 && G == 41)
        gather_rows_kernel<41><<<grid, kThreads, 0, st>>>(a);
    else if (which == 1)
        gather_rows_kernel<19><<<grid, kThreads, 0, st>>>(a);
    else if (G == 41)
        gather_staged_kernel<41><<<grid, kThreads, 0, st>>>(a);
    else
        gather_staged_kernel<19><<<grid, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// Variant 3 at W windows a CTA, for the G of the span path's sites.
extern "C" int gather_span_direct_launch(const void* p0, const void* p1,
                                         const void* p2, const void* p3,
                                         int nplanes, const void* by,
                                         const void* bx, void* out, int nb,
                                         int Hp, int Wp, int G, int W,
                                         void* stream) {
    if (bad_args(nplanes, Hp, Wp, G) || nb == 0 || W < 8 || W % 8 ||
        W > kMaxSpan || ceil_div(W * G * G, 8 * kThreads) > kMaxChunks ||
        reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    const Args a = make_args(p0, p1, p2, p3, nplanes, by, bx, out, nb, Hp,
                             Wp, G);
    cudaStream_t st = (cudaStream_t)stream;
    switch (G) {
    case 7: span_direct<7>(a, W, st); break;
    case 11: span_direct<11>(a, W, st); break;
    case 14: span_direct<14>(a, W, st); break;
    case 17: span_direct<17>(a, W, st); break;
    case 19: span_direct<19>(a, W, st); break;
    case 22: span_direct<22>(a, W, st); break;
    case 25: span_direct<25>(a, W, st); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
