// Integer-pel motion search: SAD sweep + first-minimum argmin per block.
//
// Replaces the TPU kernel homerhevc_tpu/ops/me_pallas.py (_me_kernel via
// integer_me_pallas). For every B x B block of `cur`, the minimum over the
// (2S+1)^2 window offsets of SAD + mvcost[o], where o enumerates (dy, dx) in
// dy-major raster order; on equal cost the lower o wins (the reference's
// strict-less sweep, me_pallas.py:51-53). Samples are 8-bit (0..255) held
// in uint8 or int16 planes; other values are outside the contract.
//
// What bounds it on an H100: instructions, not bytes. The function needs
// nblocks * (2S+1)^2 * B^2 absolute differences (1.03e9 at 736x1280, B 32,
// S 16) but reads only the two planes once (4.4 MB, 1.3 us of HBM time).
// So neither TMA nor wgmma is used: there is next to nothing to copy, and
// a sum of absolute differences is not a matrix product.
//
// Design (sm_90a): one CTA per block.
//  * Staging packs the block and its (B + 2S)^2 reference window to bytes in
//    shared memory (1 KB + 4.3 KB at B 32, S 16), reading the planes as
//    16-byte vectors where the start is aligned and word by word otherwise.
//  * Four differences per instruction: vabsdiff4 with accumulate on packed
//    words (the instruction behind __vsadu4; one VABSDIFF4.U8.ACC in SASS,
//    running at the full integer rate of 64 lanes per clock and SM).
//  * Register tiling over dx: a work item is one dy and kG = 3 groups of
//    four neighbouring dx. Per block row it loads the row's B/4 words (one
//    address for every thread: a broadcast) and B/4 + kG - 1 window entries
//    once and feeds 4 kG accumulators.
//  * The byte-shifted window words that the three odd offsets of a group
//    need depend on the window row only, not on the block row it meets. So
//    after staging, the CTA forms them once (funnel shifts of neighbouring
//    words) and keeps the window as quadruples {w, w >> 8, w >> 16, w >> 24}:
//    the sweep then spends a 16-byte shared load where it would spend three
//    shifts, and the integer pipe, which is what bounds the kernel, runs
//    little but VABSDIFF4 (96 of 108 instructions per row and item).
//  * The window's row pitch is an odd number of entries and neighbouring
//    lanes take neighbouring dy, so a warp's window loads fall into
//    different banks.
//  * The CTA has one thread per work item ((2S+1) * ceil(ceil((2S+1)/4)/kG)
//    of them: 99 at S 16, in 128 threads), so no thread goes through a
//    second round. Splitting the three items of the fourth warp by rows
//    over the other three warps was measured and gained nothing: with 21
//    instead of 28 warps on an SM the sweep's latencies show.
//  * A thread's offsets are not visited in rising order, so every compare,
//    in the thread and in the shuffle reduction, is the lexicographic
//    (cost, offset) one: the first minimum wins, as in the reference.
//  B 64, 32 and 16 are compiled in (at B 64 and S 16 the window and its
//  pre-shifted copy take 52 KB of shared memory, past the 48 KB a launch
//  gets without opting in); any other multiple of 4 takes a generic kernel
//  with one group per work item and the shifts in the sweep.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kBig = 0x7fffffff;
constexpr int kG = 3;  // groups of four offsets per work item

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

// acc + sum over the four bytes of |a.byte - b.byte|
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
    uint32_t d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d)
        : "r"(a), "r"(b), "r"(acc));
    return d;
}

// Pack the rows x cols patch of 8-bit samples at src[(y0 + r) * pitch + x0 +
// c] (T = uint8_t or int16_t) to bytes: row r goes to dst + r * dpw, sample c
// to byte c of the row. All dpw words of a row are written, zero past cols.
template <typename T>
__device__ void stage(const T* __restrict__ src, int pitch, int y0, int x0,
                      int rows, int cols, uint32_t* dst, int dpw) {
    const T* base = src + (size_t)y0 * pitch + x0;
    constexpr int kVec = 16 / (int)sizeof(T);  // samples per 16-byte load
    constexpr int kWords = kVec / 4;           // packed words they fill
    const bool aligned =
        (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
        ((size_t)pitch * sizeof(T)) % 16 == 0;
    const int nvec = aligned ? cols / kVec : 0;
    for (int t = threadIdx.x; t < rows * nvec; t += blockDim.x) {
        const int r = t / nvec, v = t - r * nvec;
        const uint4 q = *reinterpret_cast<const uint4*>(
            base + (size_t)r * pitch + v * kVec);
        uint32_t* d = dst + r * dpw + v * kWords;
        if constexpr (sizeof(T) == 1) {
            d[0] = q.x;
            d[1] = q.y;
            d[2] = q.z;
            d[3] = q.w;
        } else {  // low byte of each of eight int16 samples
            d[0] = __byte_perm(q.x, q.y, 0x6420);
            d[1] = __byte_perm(q.z, q.w, 0x6420);
        }
    }
    // ragged part: the words the vectors did not cover, sample by sample
    const int w0 = nvec * kWords;
    const int nw = dpw - w0;
    for (int t = threadIdx.x; t < rows * nw; t += blockDim.x) {
        const int r = t / nw, w = w0 + (t - r * nw);
        const T* s = base + (size_t)r * pitch;
        uint32_t word = 0;
        for (int i = 0; i < 4; ++i) {
            const int c = 4 * w + i;
            if (c < cols) word |= (uint32_t)(uint8_t)s[c] << (8 * i);
        }
        dst[r * dpw + w] = word;
    }
}

struct Args {
    const void* cur;        // (H, W) uint8 or int16
    const void* ref;        // (H + 2 pad, W + 2 pad) uint8 or int16
    const int32_t* mvcost;  // ((2S+1)^2,)
    int32_t* cost;          // (H / B, W / B)
    int32_t* idx;
    int W, Wp, B, S, pad;
    int pw;                 // window row pitch in words (odd)
    int cur_u8, ref_u8;
};

// Stage block (B rows of B/4 words at smem) and window (B + 2S rows of pw
// words behind it) of the CTA's block.
__device__ void stage_block(const Args& a, uint32_t* blk, uint32_t* win) {
    const int B = a.B, L = a.B + 2 * a.S;
    const int y0 = blockIdx.y * B, x0 = blockIdx.x * B;
    const int ry0 = a.pad - a.S + y0, rx0 = a.pad - a.S + x0;
    if (a.cur_u8)
        stage((const uint8_t*)a.cur, a.W, y0, x0, B, B, blk, B / 4);
    else
        stage((const int16_t*)a.cur, a.W, y0, x0, B, B, blk, B / 4);
    if (a.ref_u8)
        stage((const uint8_t*)a.ref, a.Wp, ry0, rx0, L, L, win, a.pw);
    else
        stage((const int16_t*)a.ref, a.Wp, ry0, rx0, L, L, win, a.pw);
    __syncthreads();
}

// CTA-wide lexicographic minimum of every thread's (cost, offset); thread 0
// writes the block's result.
__device__ void reduce_store(const Args& a, int best_c, int best_o) {
    __shared__ int red_c[kMaxThreads / 32];
    __shared__ int red_i[kMaxThreads / 32];
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
            const int b = blockIdx.y * gridDim.x + blockIdx.x;
            a.cost[b] = best_c;
            a.idx[b] = best_o;
        }
    }
}

// One block row against one window row for a work item: adds the row's
// absolute differences of the item's 4 kG offsets to acc. `brow` is the block
// row (BW words), `wrow` the item's first window quadruple {word, word >> 8,
// word >> 16, word >> 24} (each shift pulling in the next word's bytes), so
// that the shifted words cost a 16-byte shared load and no funnel shifts.
template <int BW>
__device__ __forceinline__ void row_sads(const uint32_t* brow,
                                         const uint32_t* wrow,
                                         uint32_t (&acc)[4 * kG]) {
    static_assert(BW % 4 == 0, "block rows are read as 16-byte vectors");
    uint32_t c[BW];
    const uint4* b4 = reinterpret_cast<const uint4*>(brow);
#pragma unroll
    for (int k = 0; k < BW / 4; ++k) {
        const uint4 q = b4[k];
        c[4 * k] = q.x;
        c[4 * k + 1] = q.y;
        c[4 * k + 2] = q.z;
        c[4 * k + 3] = q.w;
    }
    // window entry m of this item pairs with block word k = m - g for group
    // g; byte shift j gives offset dx = 4 * (chunk * kG + g) + j
#pragma unroll
    for (int m = 0; m < BW + kG - 1; ++m) {
        const uint4 q = reinterpret_cast<const uint4*>(wrow)[m];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
            const int k = m - g;
            if (k >= 0 && k < BW) {
                acc[4 * g] = sad4(c[k], q.x, acc[4 * g]);
                acc[4 * g + 1] = sad4(c[k], q.y, acc[4 * g + 1]);
                acc[4 * g + 2] = sad4(c[k], q.z, acc[4 * g + 2]);
                acc[4 * g + 3] = sad4(c[k], q.w, acc[4 * g + 3]);
            }
        }
    }
}

// B = 4 * BW known at compile time: the block row lives in registers and the
// loop over its words is unrolled. Shared memory: block, then the window as
// quadruples of pre-shifted words (what the sweep reads), then the packed
// window they are formed from.
template <int BW>
__global__ void __launch_bounds__(kMaxThreads) me_sad_kernel(Args a) {
    extern __shared__ __align__(16) uint32_t smem[];
    constexpr int B = 4 * BW;
    const int L = B + 2 * a.S;
    uint32_t* blk = smem;
    uint32_t* sweep = smem + B * BW;
    uint32_t* win = sweep + 4 * L * a.pw;
    stage_block(a, blk, win);
    for (int t = threadIdx.x; t < L * a.pw; t += blockDim.x) {
        const int m = t % a.pw;
        const uint32_t w0 = win[t];
        const uint32_t w1 = m + 1 < a.pw ? win[t + 1] : 0u;
        reinterpret_cast<uint4*>(sweep)[t] =
            make_uint4(w0, __funnelshift_r(w0, w1, 8),
                       __funnelshift_r(w0, w1, 16),
                       __funnelshift_r(w0, w1, 24));
    }
    __syncthreads();

    const int n = 2 * a.S + 1;
    const int nchunk = ((n + 3) / 4 + kG - 1) / kG;
    const int items = n * nchunk;
    int best_c = kBig, best_o = kBig;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        // dy runs fastest over the lanes: with an odd row pitch a warp's
        // window loads hit different banks
        const int chunk = item / n, dy = item - chunk * n;
        uint32_t acc[4 * kG];
#pragma unroll
        for (int i = 0; i < 4 * kG; ++i) acc[i] = 0;
        const uint32_t* wr = sweep + (dy * a.pw + chunk * kG) * 4;
        for (int yy = 0; yy < B; ++yy, wr += a.pw * 4)
            row_sads<BW>(blk + yy * BW, wr, acc);
#pragma unroll
        for (int i = 0; i < 4 * kG; ++i) {
            const int dx = 4 * chunk * kG + i;
            if (dx < n) {
                const int o = dy * n + dx;
                lexmin(best_c, best_o, (int)acc[i] + a.mvcost[o], o);
            }
        }
    }
    reduce_store(a, best_c, best_o);
}

// Any B that is a multiple of 4: the same sweep with one word group per work
// item and the block row read from shared memory word by word.
__global__ void __launch_bounds__(kMaxThreads) me_sad_generic_kernel(Args a) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int B = a.B, BW = a.B / 4;
    uint32_t* blk = smem;
    uint32_t* win = smem + B * BW;
    stage_block(a, blk, win);

    const int n = 2 * a.S + 1;
    const int nchunk = (n + 3) / 4;
    const int items = n * nchunk;
    int best_c = kBig, best_o = kBig;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const int chunk = item / n, dy = item - chunk * n;
        uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        const uint32_t* wr = win + dy * a.pw + chunk;
        for (int yy = 0; yy < B; ++yy, wr += a.pw) {
            const uint32_t* br = blk + yy * BW;
            uint32_t w0 = wr[0];
            for (int k = 0; k < BW; ++k) {
                const uint32_t w1 = wr[k + 1];
                const uint32_t c = br[k];
                a0 = sad4(c, w0, a0);
                a1 = sad4(c, __funnelshift_r(w0, w1, 8), a1);
                a2 = sad4(c, __funnelshift_r(w0, w1, 16), a2);
                a3 = sad4(c, __funnelshift_r(w0, w1, 24), a3);
                w0 = w1;
            }
        }
        const uint32_t acc[4] = {a0, a1, a2, a3};
        for (int i = 0; i < 4; ++i) {
            const int dx = 4 * chunk + i;
            if (dx < n) {
                const int o = dy * n + dx;
                lexmin(best_c, best_o, (int)acc[i] + a.mvcost[o], o);
            }
        }
    }
    reduce_store(a, best_c, best_o);
}

// Same grid and CTA size, no work: what a launch of this shape costs.
__global__ void me_sad_floor_kernel() {}

struct Config {
    bool tiled;   // B 64, 32 or 16: me_sad_kernel; else the generic kernel
    int pw;       // window row pitch in words (odd)
    int threads;
    size_t smem;
};

// Built with -DME_SAD_GENERIC_ONLY (tools/kernel_report.py does, to time the
// tiles against it), every B takes the generic kernel.
#ifdef ME_SAD_GENERIC_ONLY
bool has_tile(int) { return false; }
#else
bool has_tile(int B) { return B == 64 || B == 32 || B == 16; }
#endif

Config config(int B, int S) {
    Config c;
    c.tiled = has_tile(B);
    const int G = c.tiled ? kG : 1;
    const int n = 2 * S + 1, L = B + 2 * S;
    const int nchunk = ((n + 3) / 4 + G - 1) / G;
    c.pw = (B / 4 + nchunk * G) | 1;
    const int items = n * nchunk;
    c.threads = (items + 31) / 32 * 32;
    if (c.threads > kMaxThreads) c.threads = kMaxThreads;
    c.smem = (size_t)(B * (B / 4) + (c.tiled ? 5 : 1) * L * c.pw)
             * sizeof(uint32_t);
    return c;
}

template <typename K>
cudaError_t run(K kernel, const Args& a, dim3 grid, const Config& c,
                cudaStream_t stream) {
    if (c.smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<grid, c.threads, c.smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" int me_sad_launch(const void* cur, const void* ref,
                             const void* mvcost, void* cost, void* idx, int H,
                             int W, int Wp, int B, int S, int pad, int cur_u8,
                             int ref_u8, void* stream) {
    if (B <= 0 || B % 4 || S < 0 || S > pad) return (int)cudaErrorInvalidValue;
    const Config c = config(B, S);
    Args a{cur, ref, (const int32_t*)mvcost, (int32_t*)cost, (int32_t*)idx,
           W, Wp, B, S, pad, c.pw, cur_u8, ref_u8};
    const dim3 grid(W / B, H / B);
    cudaStream_t st = (cudaStream_t)stream;
    if (c.tiled && B == 64) return (int)run(me_sad_kernel<16>, a, grid, c, st);
    if (c.tiled && B == 32) return (int)run(me_sad_kernel<8>, a, grid, c, st);
    if (c.tiled && B == 16) return (int)run(me_sad_kernel<4>, a, grid, c, st);
    return (int)run(me_sad_generic_kernel, a, grid, c, st);
}

// An empty kernel with me_sad_launch's grid and CTA size.
extern "C" int me_sad_floor_launch(int H, int W, int B, int S, void* stream) {
    const Config c = config(B, S);
    me_sad_floor_kernel<<<dim3(W / B, H / B), c.threads, 0,
                          (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* me_sad_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
