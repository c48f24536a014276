// Kernel A of the radar front-end on Hopper: Hamming window, range FFT and
// corner turn, as a register-resident two-pass transform.
//
// Replaces the first half of fmcw_tpu/ops/frontend_pallas.py::_kernel (:623;
// stages 1-4 of its docstring: window, outer DFT over the lane slices,
// twiddle, inner 128-point DFT on the MXU) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_range (:73).  The TPU kernel keeps
// the whole 1 MiB frame in VMEM; here the frame is cut along the chirp axis
// into groups of kChirps = 8 chirps, and the slow-time half runs as kernel B
// (slowtime_detect.cu) on range tiles.
//
// In:  iq int16 (B, nd, n, 2), I/Q interleaved (read as one 32-bit word),
//      or (fmcw_range_fft_float, the array model's beamformed data) planar
//      float32 re/im (B, nd, n) — the TPU kernel casts either type to f32
//      before the window (frontend_pallas.py:672-673).
// Out: planar float32 re/im, RANGE-major (B, n, nd) — the corner turn is this
//      kernel's store.
//
// Bound on an H100: bytes.  Per 1024x128 frame 0.5 MiB is read (1 MiB for
// float input) and 1 MiB written: 0.0601 ms for a batch of 128 at 3.35 TB/s
// (0.0801 ms for float input); the FFT is 5 n log2 n flops a chirp, 6.6
// MFLOP a frame, 0.013 ms a batch at 67 TFLOP/s FP32.  So the kernel must
// keep HBM streaming and spend little else.
//
// The plan.  n = N1 x N2, N2 = 2^floor(log2(n) / 2), N1 = n / N2 (32 x 32
// at n = 1024).  A group's input (8 consecutive chirps, one contiguous run
// of 32 KiB int16 or 2 x 32 KiB float at n = 1024) arrives by one TMA bulk
// copy per plane into shared memory.  A large batch runs one block per
// group and leaves the balancing to the block scheduler; a small one (fewer
// than four groups per resident block, e.g. a chirp shard) keeps every
// block resident, walking the groups gi = blockIdx.x + k gridDim.x with the
// next group's copy in flight while this one is transformed.  Per group:
//  1. pass 1: lane t of chirp c1 (N2 lanes a chirp, 32 / N2 chirps a warp)
//     takes samples t + N2 m, m < N1, windows them and runs an N1-point DFT
//     over m in registers (radix-2, constant twiddles W_32^e as float
//     literals), then multiplies by W_n^(t ka) from the host table, laid out
//     tw[ka N2 + t] so that a warp reads it coalesced;
//  2. the exchange: the values go through shared memory, one padded region
//     per chirp and plane, re and im at once; one block barrier;
//  3. pass 2: thread (chirp c2 = tid mod 8, column q = tid / 8) runs N2-point
//     DFTs over t for its columns q + N2 j and holds X[q + N2 j + N1 kb];
//  4. the corner turn is the store, straight from registers: a warp holds 8
//     chirps x 4 consecutive columns, so each store instruction writes 4
//     range rows x 8 consecutive chirps, whole 32-byte sectors.
// Two block barriers a group.  At n = 1024 both sides of the exchange touch
// 32 banks per warp instruction; 128 registers a thread for int16 input
// (two resident blocks of 256 threads: 98 KiB of shared memory each), one
// 130 KiB block for float input.  The window and twiddles are read per group
// (volatile loads, L1 hits) instead of being hoisted into registers.
// FP32 with FMA throughout; each chirp's arithmetic depends on nothing but
// the chirp, so a chirp shard gives exactly the whole frame's columns.
// Agreement with the plain twin (window times dense DFT matmul) is held to
// 1e-5 of the map peak.  tests/test_torch_range_fft_plan.py models this plan
// (loads, DFTs, twiddle and exchange indices, store) in numpy.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kChirps = 8;      // chirps per group, a block's unit of work
constexpr int kMinLog2N = 4;
constexpr int kMaxLog2N = 10;

// W_32^e = exp(-2 pi i e / 32), e < 16: cos and sin computed in float64 and
// rounded to float32.  Indexed by compile-time constants only, so each read
// is an operand of the FMA that uses it.
__constant__ float kW32Re[16] = {
    1.0f, 0.98078525f, 0.9238795f, 0.8314696f, 0.70710677f, 0.55557024f,
    0.38268343f, 0.19509032f, 6.123234e-17f, -0.19509032f, -0.38268343f,
    -0.55557024f, -0.70710677f, -0.8314696f, -0.9238795f, -0.98078525f};
__constant__ float kW32Im[16] = {
    -0.0f, -0.19509032f, -0.38268343f, -0.55557024f, -0.70710677f,
    -0.8314696f, -0.9238795f, -0.98078525f, -1.0f, -0.98078525f, -0.9238795f,
    -0.8314696f, -0.70710677f, -0.55557024f, -0.38268343f, -0.19509032f};

__host__ __device__ constexpr int bit_reverse(int k, int bits) {
    int r = 0;
    for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
    return r;
}

// f(I) for I = 0 .. N - 1, each I a compile-time constant (an
// std::integral_constant): register arrays are only ever indexed by
// constants, so they stay in registers.
template <typename F, int... Is>
__device__ __forceinline__ void unrolled(F&& f,
                                         std::integer_sequence<int, Is...>) {
    (f(std::integral_constant<int, Is>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    unrolled(f, std::make_integer_sequence<int, N>{});
}

// The factorisation, launch shape and shared memory for n = 2^kLog2N.
template <bool kFloat, int kLog2N>
struct Plan {
    static constexpr int n = 1 << kLog2N;
    static constexpr int kLog2N2 = kLog2N / 2;
    static constexpr int N2 = 1 << kLog2N2;          // lanes per chirp
    static constexpr int N1 = n / N2;                // points per lane
    static constexpr int kLog2N1 = kLog2N - kLog2N2;
    static constexpr int kThreads = kChirps * N2;
    static constexpr int kRow = N1 + 1;              // exchange row (t)
    // A chirp's exchange region, padded to 4 (mod 32) words: the second
    // pass's warp (8 chirps x 4 columns) then reads 32 banks at n = 1024.
    static constexpr int kRegion = N2 * kRow + (36 - N2 * kRow % 32) % 32;
    static constexpr int kExchange = kChirps * kRegion;   // one plane
    static constexpr int kPlane = kChirps * n;       // one input plane
    static constexpr int kIn = kPlane * (kFloat ? 2 : 1);
    static constexpr int kInBytes = kIn * 4;
    // Input buffer, the two exchange planes, the mbarrier.
    static constexpr int kSmemBytes = (kIn + 2 * kExchange) * 4 + 16;
    // Resident blocks: as many as shared memory allows, at most 512 threads
    // an SM (128 registers a thread).
    static constexpr int kBySmem = 232448 / (kSmemBytes + 1024);
    static constexpr int kByRegs = kThreads >= 512 ? 1 : 512 / kThreads;
    static constexpr int kMinBlocks = kBySmem < kByRegs ? kBySmem : kByRegs;
};

// (r + i i) *= W_32^e.
template <int e>
__device__ __forceinline__ void rotate32(float& r, float& i) {
    if constexpr (e == 8) {             // W_32^8 = -i, exact
        const float t = r;
        r = i;
        i = -t;
    } else if constexpr (e != 0) {
        const float c = kW32Re[e], s = kW32Im[e];
        const float nr = fmaf(r, c, -i * s);
        i = fmaf(r, s, i * c);
        r = nr;
    }
}

// Radix-2 DIF stages kHalf, kHalf / 2, ..., 1 of an N-point forward DFT of
// x[kOff .. kOff + N); the result in bit-reversed order.
template <int N, int kHalf, int kOff, int M>
__device__ __forceinline__ void dif(float (&xr)[M], float (&xi)[M]) {
    static_for<N / (2 * kHalf)>([&](auto blk) {
        static_for<kHalf>([&](auto jj) {
            constexpr int j = decltype(jj)::value;
            constexpr int a = kOff + decltype(blk)::value * 2 * kHalf + j;
            constexpr int b = a + kHalf;
            float dr = xr[a] - xr[b], di = xi[a] - xi[b];
            xr[a] += xr[b];
            xi[a] += xi[b];
            rotate32<j * (16 / kHalf)>(dr, di);   // W_(2 kHalf)^j
            xr[b] = dr;
            xi[b] = di;
        });
    });
    if constexpr (kHalf > 1) dif<N, kHalf / 2, kOff, M>(xr, xi);
}

template <int N, int kOff, int M>
__device__ __forceinline__ void dft(float (&xr)[M], float (&xi)[M]) {
    dif<N, N / 2, kOff, M>(xr, xi);
}

// Loads the compiler may not hoist out of the group loop (a volatile asm):
// the window and twiddles are read per group, not held in registers.
__device__ __forceinline__ float ld_nc(const float* p) {
    float v;
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ float2 ld_nc(const float2* p) {
    float2 v;
    asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "l"(p));
    return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One thread: group gi's input (8 consecutive chirps, contiguous in each
// plane) into `buf`, completion counted on `bar`.
template <typename P>
__device__ __forceinline__ void prefetch(const void* src0, const void* src1,
                                         float* buf, uint64_t* bar, int gi) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(P::kInBytes) : "memory");
    const size_t off = (size_t)gi * P::kPlane;
    bulk_load(smem_addr(buf), static_cast<const float*>(src0) + off,
              P::kPlane * 4, b);
    if constexpr (P::kIn > P::kPlane)   // float input: the im plane
        bulk_load(smem_addr(buf + P::kPlane),
                  static_cast<const float*>(src1) + off, P::kPlane * 4, b);
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
    const uint32_t b = smem_addr(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(b), "r"(parity) : "memory");
    } while (!done);
}

// Pass 1 -> pass 2: the first pass's lane (chirp c1, t) writes its column
// values Y[t][ka] (bit-reversed in x) into the chirp's region; after the
// barrier the second pass's thread (chirp c2, column q + N2 j) reads row t'
// of its column into x[j N2 + t'].
template <typename P>
__device__ __forceinline__ void put(const float (&x)[P::N1], float* xch,
                                    int c1, int t) {
    static_for<P::N1>([&](auto ka) {
        constexpr int K = decltype(ka)::value;
        xch[c1 * P::kRegion + t * P::kRow + K] = x[bit_reverse(K, P::kLog2N1)];
    });
}

template <typename P>
__device__ __forceinline__ void get(float (&x)[P::N1], const float* xch,
                                    int c2, int q) {
    static_for<P::N1>([&](auto i) {
        constexpr int j = decltype(i)::value / P::N2;
        constexpr int tp = decltype(i)::value % P::N2;
        x[j * P::N2 + tp] = xch[c2 * P::kRegion + tp * P::kRow + q + P::N2 * j];
    });
}

// kFloat: the input is two float32 planes (src0 = re, src1 = im); else
// src0 is the int16 I/Q pairs.
template <bool kFloat, int kLog2N>
__global__ void __launch_bounds__(Plan<kFloat, kLog2N>::kThreads,
                                  Plan<kFloat, kLog2N>::kMinBlocks)
range_fft_kernel(const void* __restrict__ src0, const void* __restrict__ src1,
                 const float* __restrict__ win, const float2* __restrict__ tw,
                 float* __restrict__ out_re, float* __restrict__ out_im,
                 int nd, int groups) {
    using P = Plan<kFloat, kLog2N>;
    constexpr int n = P::n, N1 = P::N1, N2 = P::N2;
    extern __shared__ __align__(16) float smem[];
    float* in = smem;
    float* xch = smem + P::kIn;
    uint64_t* bar = reinterpret_cast<uint64_t*>(xch + 2 * P::kExchange);
    const int per_frame = nd / kChirps;

    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        prefetch<P>(src0, src1, in, bar, blockIdx.x);
    }
    __syncthreads();

    int it = 0;
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x, ++it) {
        wait_parity(bar, it & 1);
        // The thread's indices, read anew each group: nothing derived from
        // them is held in registers across the loop.
        int tid;
        asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
        const int t = tid & (N2 - 1);                  // pass 1: lane t
        const int c1 = tid >> P::kLog2N2;              //   of chirp c1
        const int c2 = tid & (kChirps - 1);            // pass 2: chirp c2,
        const int q = tid / kChirps;                   //   columns q + N2 j

        // 1. Window: lane t takes samples t + N2 m of chirp c1.
        float xr[N1], xi[N1];
        if constexpr (kFloat) {
            const float* re = in + c1 * n + t;
            const float* im = re + P::kPlane;
            static_for<N1>([&](auto mm) {
                constexpr int m = decltype(mm)::value;
                xr[m] = re[N2 * m];
                xi[m] = im[N2 * m];
            });
        } else {
            const uint32_t* iq =
                reinterpret_cast<const uint32_t*>(in) + c1 * n + t;
            static_for<N1>([&](auto mm) {
                constexpr int m = decltype(mm)::value;
                const uint32_t w = iq[N2 * m];
                xr[m] = (float)(int16_t)(w & 0xffffu);
                xi[m] = (float)(int16_t)(w >> 16);
            });
        }
        static_for<N1>([&](auto mm) {
            constexpr int m = decltype(mm)::value;
            const float w = ld_nc(win + t + N2 * m);
            xr[m] = __fmul_rn(xr[m], w);
            xi[m] = __fmul_rn(xi[m], w);
        });

        // 2. N1-point DFT over m, then W_n^(t ka) = tw[ka N2 + t].
        dft<N1, 0, N1>(xr, xi);
        static_for<N1 - 1>([&](auto kk) {
            constexpr int ka = decltype(kk)::value + 1;
            constexpr int p = bit_reverse(ka, P::kLog2N1);
            const float2 w = ld_nc(tw + ka * N2 + t);
            const float r = fmaf(xr[p], w.x, -xi[p] * w.y);
            xi[p] = fmaf(xr[p], w.y, xi[p] * w.x);
            xr[p] = r;
        });

        // 3. Exchange across the block's chirps.  The barrier also frees
        //    the input buffer: the next group's load starts into it.
        put<P>(xr, xch, c1, t);
        put<P>(xi, xch + P::kExchange, c1, t);
        __syncthreads();
        if (tid == 0 && gi + (int)gridDim.x < groups) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            prefetch<P>(src0, src1, in, bar, gi + gridDim.x);
        }
        get<P>(xr, xch, c2, q);
        get<P>(xi, xch + P::kExchange, c2, q);
        __syncthreads();                // the regions are free again

        // 4. N2-point DFTs over t': x[j N2 + bit_reverse(kb)] = X[q + N2 j
        //    + N1 kb] of chirp c2; stored straight from registers, each warp
        //    instruction 4 range rows x 8 consecutive chirps (32 bytes).
        static_for<N1 / N2>([&](auto jj) {
            constexpr int j = decltype(jj)::value;
            dft<N2, j * N2, N1>(xr, xi);
        });
        const int b = gi / per_frame;
        const int c0 = (gi - b * per_frame) * kChirps;
        const size_t base = (size_t)b * n * nd + c0 + c2;
        static_for<N1>([&](auto i) {
            constexpr int j = decltype(i)::value / N2;
            constexpr int kb = decltype(i)::value % N2;
            constexpr int p = j * N2 + bit_reverse(kb, P::kLog2N2);
            const size_t at = base + (size_t)(q + N2 * j + N1 * kb) * nd;
            out_re[at] = xr[p];
            out_im[at] = xi[p];
        });
    }
}

// Launches one block per group when there are more than four groups per
// resident block slot (blocks per SM x SMs, computed once per process), else
// one block per slot (or per group, if fewer), each walking its groups.
template <bool kFloat, int kLog2N>
cudaError_t launch_n(const void* src0, const void* src1, const void* win,
                     const void* tw, void* out_re, void* out_im, int batch,
                     int nd, cudaStream_t stream) {
    using P = Plan<kFloat, kLog2N>;
    auto* kernel = range_fft_kernel<kFloat, kLog2N>;
    static int slots = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
    if (err != cudaSuccess) return err;
    if (slots == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, P::kThreads, P::kSmemBytes);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        slots = per_sm * sms;
    }
    const int groups = batch * (nd / kChirps);
    const int grid = groups > 4 * slots ? groups
                     : groups < slots   ? groups
                                        : slots;
    kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(
        src0, src1, static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out_re),
        static_cast<float*>(out_im), nd, groups);
    return cudaGetLastError();
}

int log2_exact(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return (1 << l) == n ? l : -1;
}

template <bool kFloat>
int launch(const void* src0, const void* src1, const void* win,
           const void* tw, void* out_re, void* out_im, int batch, int nd,
           int n, void* stream) {
    const int log2n = log2_exact(n);
    if (batch < 1 || log2n < kMinLog2N || log2n > kMaxLog2N ||
        nd < kChirps || nd % kChirps != 0 ||
        (long long)batch * nd > 0x7fffffffLL ||
        ((reinterpret_cast<uintptr_t>(src0) |
          reinterpret_cast<uintptr_t>(src1)) & 15))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    switch (log2n) {
#define FMCW_RANGE_FFT_CASE(L)                                              \
    case L:                                                                 \
        err = launch_n<kFloat, L>(src0, src1, win, tw, out_re, out_im,      \
                                  batch, nd, s);                            \
        break;
        FMCW_RANGE_FFT_CASE(4)
        FMCW_RANGE_FFT_CASE(5)
        FMCW_RANGE_FFT_CASE(6)
        FMCW_RANGE_FFT_CASE(7)
        FMCW_RANGE_FFT_CASE(8)
        FMCW_RANGE_FFT_CASE(9)
        FMCW_RANGE_FFT_CASE(10)
#undef FMCW_RANGE_FFT_CASE
    }
    return (int)err;
}

template <bool kFloat>
int blocks_per_sm() {
    using P = Plan<kFloat, kMaxLog2N>;
    auto* kernel = range_fft_kernel<kFloat, kMaxLog2N>;
    int blocks = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, P::kThreads, P::kSmemBytes);
    return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// iq: int16 (batch, nd, n, 2), 16-byte aligned; win: float32 (n,); tw:
// complex float32 (n,) with tw[ka N2 + t] = exp(-2 pi i t ka / n) for the
// plan's n = N1 x N2 (ops/frontend._tables); out_re/out_im: float32 (batch,
// n, nd).  Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_range_fft(const void* iq, const void* win, const void* tw,
                              void* out_re, void* out_im, int batch, int nd,
                              int n, void* stream) {
    return launch<false>(iq, nullptr, win, tw, out_re, out_im, batch, nd, n,
                         stream);
}

// The same for planar float32 input re/im (batch, nd, n), each 16-byte
// aligned.
extern "C" int fmcw_range_fft_float(const void* re, const void* im,
                                    const void* win, const void* tw,
                                    void* out_re, void* out_im, int batch,
                                    int nd, int n, void* stream) {
    return launch<true>(re, im, win, tw, out_re, out_im, batch, nd, n,
                        stream);
}

// Resident blocks per SM of the n = 1024 kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), int16 or float input; a
// negative CUDA error code on failure.
extern "C" int fmcw_range_fft_blocks_per_sm(int is_float) {
    return is_float ? blocks_per_sm<true>() : blocks_per_sm<false>();
}
