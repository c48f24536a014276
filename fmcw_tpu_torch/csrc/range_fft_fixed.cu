// Fixed-point range half of the radar front-end on Hopper: Q15 window with
// saturation count, FP64 range FFT, block-floating-point quantization per
// chirp and corner turn, as a register-resident two-pass transform.
//
// Replaces the range half of fmcw_tpu/ops/frontend_pallas.py::_kernel_fixed
// (:813; steps 1-5: integer window with saturation counting, range DFT, BFP
// quantize over each chirp's range transform) and its split counterpart
// fmcw_tpu/ops/split_frontend.py::_kernel_range_fixed (:111).
//
// In:  iq int16 (B, nd, n, 2), I/Q interleaved (read as one 32-bit word),
//      16-byte aligned; the int32 Q15 window (n,); the float64 twiddles
//      between the passes, tw[ka N2 + t] = W_n^(t ka) taken from
//      ops/fft.twiddles64 (ops/frontend_fixed._range_tables).
// Out: int16 re/im planes, RANGE-major (B, n, nd) — the quantized values are
//      int16 by construction; sat (B,) int32 += the window's saturated
//      samples, I and Q counted separately (zeroed by the caller).
//
// Per chirp: (x * w + rnd) >> shift (arithmetic) clipped to int16, counted
// when clipped (window_multiplier.vhd:119-163); the FFT in FP64; s = max(0,
// ceil(log2(peak / 2^15))) over the chirp's n bins, read from the bits of
// the peak (fmcw::bfp_scale); each value times 2^-s (exact) rounded half to
// even and clipped to int16 (ops/fft.bfp_quantize).
//
// Why FP64, and why the quarter turns must be exact: the pre-BFP values
// reach ~3e7, where an FP32 ulp is 2, so an FP32 FFT moves a value near a
// rounding boundary by 1 LSB.  In FP64 the error is ~1e-8 of an LSB, so a
// value lands on the golden model's side of every boundary that it does
// not sit on exactly.  Values that sit exactly on a half-LSB tie are the
// integer-valued bins of integer input: k = 0, n/4, n/2, 3n/4.  Along their
// paths through this plan (ka = 0 in pass 1, kb a multiple of N2/4 in pass
// 2) every operation is an add, a subtract or a product with exactly 0, +-1
// or +-i (W_32^8 is a swap), so they are computed exactly and round as the
// golden model's do.  The FP64 constants below are ops/fft.twiddles64(32),
// exactly 0 / -1 at the quarter turn (tests/test_torch_range_fft_fixed_
// plan.py parses and checks them).  A frame can also put a tie on an
// eighth-turn bin (k = m n/8, m odd), where the sqrt(2)/2 terms of the sum
// cancel; at n >= 64 those bins are computed as an exact integer part plus
// one FMA of cos(pi/4) and an exact integer sum (eighth_turn_bins), so they
// are exact whenever the golden model's are.  Finer bins would need two or
// more irrational parts to cancel at once; this kernel does not compute
// them exactly.
//
// Bound on an H100: bytes and the FP64 pipe, close together.  Per 1024x128
// frame 0.5 MiB is read and 0.5 MiB written: 0.0401 ms for a batch of 128 at
// 3.35 TB/s; the FFT's 5 n log2 n flops a chirp are 0.0296 ms at 34 TFLOP/s
// FP64.  So the kernel keeps HBM streaming and issues few FP64 instructions
// besides the transform's.
//
// The plan (kernel A's, csrc/range_fft.cu, carried into FP64).  n = N1 x N2,
// N2 = 2^floor(log2(n) / 2), N1 = n / N2 (32 x 32 at n = 1024).  A group is
// 8 consecutive chirps (32 KiB of int16 I/Q at n = 1024); it arrives by one
// TMA bulk copy into a ring of two input buffers.  The grid is persistent
// (at most one block per resident slot; one 256-thread block an SM at n =
// 1024, its 254 registers a thread holding 32 complex doubles): each block
// walks its units, so the next copies are in flight while it transforms.
// Per group:
//  1. pass 1: lane t of chirp c1 (N2 lanes a chirp) takes samples t + N2 m,
//     m < N1, applies the Q15 window in integers (saturations summed by warp
//     into shared memory, then by block into sat[b] with one atomic),
//     converts to FP64 (exact) and runs an N1-point DIF DFT in registers
//     (radix 2^2), then multiplies by W_n^(t ka) = tw[ka N2 + t] (ka > 0);
//  2. the exchange: one FP64 region per chirp and plane, columns rotated by
//     the row (no padded rows); one block barrier; then pass 2's thread
//     (chirp c2 = tid mod 8, column q = tid / 8) reads rows t of its
//     columns q + N2 j;
//  3. pass 2: N2-point DFTs over t; X[q + N2 j + N1 kb] in registers;
//  4. BFP: each thread's peak as an integer key (|x|'s high word, which
//     orders like |x|), an integer max over the lanes of its chirp (shuffle)
//     and over the warps (one shared slot per warp and chirp, the second
//     barrier); the scale 2^-s from the key's exponent bits;
//  5. quantize in registers (x 2^-s + 1.5 2^52 in one FMA: the product is
//     exact and the sum rounds half to even to an integer).
// The store.  8 chirps give a range row 16 bytes a plane, half a 32-byte
// sector, and half-sector stores were the largest single cost of a first
// design on an H100 (PERF.md, Findings).  So where nd is a multiple of 16
// a unit is a pair of groups, 16 consecutive chirps: the first group's
// quantized tile ([plane][row][8 chirps] int16) goes to its own input
// buffer, read by then; the second's to the exchange region, free after
// its second barrier; one more barrier, then the block
// copies both tiles out in 16-byte vectors, two lanes a row, each warp
// instruction 16 rows x 32 bytes; a fourth barrier frees the tiles.  The
// two input buffers swap roles each unit: the second group's takes the next
// unit's first copy at its first barrier, the first group's the next
// unit's second copy after the copy-out.  Otherwise (nd = 8, 24, 40, ...) a
// unit is one group, stored straight from registers, each warp instruction
// 4 range rows x 8 consecutive chirps.
// At n = 1024 both sides of the exchange hit 16 distinct 8-byte bank pairs
// per half-warp, and the shared memory stays under 196 KB (the carve-out
// then leaves L1 60 KB for the window and twiddles).  A chirp's arithmetic
// depends on nothing but the chirp, so a chirp shard gives exactly the
// whole frame's columns (and its share of the saturation count).
// tests/test_torch_range_fft_fixed_plan.py models this plan in numpy, bit
// for bit against the golden model.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "fixed_point.cuh"

namespace {

constexpr int kChirps = 8;      // chirps per group, a block's unit of work
constexpr int kMinLog2N = 4;
constexpr int kMaxLog2N = 10;
constexpr int kStages = 2;      // input ring

// W_32^e = exp(-2 pi i e / 32), e < 16: ops/fft.twiddles64(32), as exact
// hex literals (e = 8 is exactly -i and is applied as a swap).  Indexed by
// compile-time constants only, so each read is an operand of its FMA.
__constant__ double kW32Re[16] = {
    0x1.0000000000000p+0, 0x1.f6297cff75cb0p-1, 0x1.d906bcf328d46p-1,
    0x1.a9b66290ea1a3p-1, 0x1.6a09e667f3bcdp-1, 0x1.1c73b39ae68c9p-1,
    0x1.87de2a6aea964p-2, 0x1.8f8b83c69a60dp-3, 0x0.0p+0,
    -0x1.8f8b83c69a608p-3, -0x1.87de2a6aea962p-2, -0x1.1c73b39ae68c6p-1,
    -0x1.6a09e667f3bccp-1, -0x1.a9b66290ea1a4p-1, -0x1.d906bcf328d46p-1,
    -0x1.f6297cff75cb0p-1};
__constant__ double kW32Im[16] = {
    0x0.0p+0, -0x1.8f8b83c69a60ap-3, -0x1.87de2a6aea963p-2,
    -0x1.1c73b39ae68c8p-1, -0x1.6a09e667f3bccp-1, -0x1.a9b66290ea1a3p-1,
    -0x1.d906bcf328d46p-1, -0x1.f6297cff75cb0p-1, -0x1.0000000000000p+0,
    -0x1.f6297cff75cb0p-1, -0x1.d906bcf328d46p-1, -0x1.a9b66290ea1a5p-1,
    -0x1.6a09e667f3bcdp-1, -0x1.1c73b39ae68c8p-1, -0x1.87de2a6aea965p-2,
    -0x1.8f8b83c69a617p-3};

__host__ __device__ constexpr int bit_reverse(int k, int bits) {
    int r = 0;
    for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
    return r;
}

// f(I) for I = 0 .. N - 1, each I a compile-time constant: register arrays
// are only ever indexed by constants, so they stay in registers.
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
template <int kLog2N>
struct Plan {
    static constexpr int n = 1 << kLog2N;
    static constexpr int kLog2N2 = kLog2N / 2;
    static constexpr int N2 = 1 << kLog2N2;          // lanes per chirp
    static constexpr int N1 = n / N2;                // points per lane
    static constexpr int kLog2N1 = kLog2N - kLog2N2;
    static constexpr int kThreads = kChirps * N2;
    static constexpr int kWarps = kThreads / 32;
    // A chirp's exchange region in doubles: N2 rows (t) of N1 columns
    // (ka), column ka of row t stored at (ka + t) mod N1, and the region
    // padded to 2 (mod 16): at n = 1024 pass 1's half-warp (16 rows) and
    // pass 2's (8 chirps x 2 columns) then hit 16 distinct 8-byte bank
    // pairs, with no padded rows (which would take shared memory past 196
    // KB, where the carve-out leaves L1 28 KB for the window and twiddles
    // instead of 60 KB).
    static constexpr int kRegion = n + (18 - n % 16) % 16;
    static constexpr int kExchange = kChirps * kRegion;   // one plane
    static constexpr int kIn = kChirps * n;          // 32-bit I/Q words
    static constexpr int kInBytes = kIn * 4;
    // A group's quantized tile: [plane][range row][8 chirps] int16, the
    // size of an input buffer.  The second group of a pair keeps its tile
    // in the exchange region, kTileSkew bytes in (the copy-out's 16-byte
    // reads of the two tiles then fall in different banks).
    static constexpr int kTileSkew = 64;
    // Input ring, the two exchange planes, per-warp peaks and saturation
    // counts, the ring's mbarriers.
    static constexpr int kOffXch = kStages * kInBytes;
    static constexpr int kOffPeak = kOffXch + 2 * kExchange * 8;
    static constexpr int kOffSat = kOffPeak + kWarps * kChirps * 4;
    static constexpr int kOffBar = kOffSat + ((kWarps * 4 + 15) / 16) * 16;
    static constexpr int kSmemBytes = kOffBar + kStages * 8;
    static_assert(kTileSkew + kInBytes <= 2 * kExchange * 8,
                  "a tile fits in the exchange region");
};

// (r + i i) *= W_32^e.
template <int e>
__device__ __forceinline__ void rotate32(double& r, double& i) {
    if constexpr (e == 8) {             // W_32^8 = -i, exact
        const double t = r;
        r = i;
        i = -t;
    } else if constexpr (e != 0) {
        const double c = kW32Re[e], s = kW32Im[e];
        const double nr = fma(r, c, -i * s);
        i = fma(r, s, i * c);
        r = nr;
    }
}

// (r + i i) *= W_32^e for any e >= 0 (W_32^(e + 16) = -W_32^e).
template <int e>
__device__ __forceinline__ void rotate32x(double& r, double& i) {
    constexpr int f = e % 32;
    rotate32<f % 16>(r, i);
    if constexpr (f >= 16) {
        r = -r;
        i = -i;
    }
}

// DIF stages kHalf, kHalf / 2, ..., 1 of an N-point forward DFT of x[kOff ..
// kOff + N), two radix-2 stages at a time as one radix-2^2 stage; the result
// in bit-reversed order.
template <int N, int kHalf, int kOff, int M>
__device__ __forceinline__ void dif(double (&xr)[M], double (&xi)[M]) {
    if constexpr (kHalf >= 2) {
        constexpr int e = 16 / kHalf;           // W_(2 kHalf) = W_32^e
        static_for<N / (2 * kHalf)>([&](auto blk) {
            static_for<kHalf / 2>([&](auto jj) {
                constexpr int j = decltype(jj)::value;
                constexpr int a0 = kOff + decltype(blk)::value * 2 * kHalf + j;
                constexpr int a1 = a0 + kHalf / 2, a2 = a0 + kHalf;
                constexpr int a3 = a2 + kHalf / 2;
                const double s02r = xr[a0] + xr[a2], s02i = xi[a0] + xi[a2];
                const double d02r = xr[a0] - xr[a2], d02i = xi[a0] - xi[a2];
                const double s13r = xr[a1] + xr[a3], s13i = xi[a1] + xi[a3];
                // (x1 - x3) (-i)
                const double d13r = xi[a1] - xi[a3], d13i = xr[a3] - xr[a1];
                xr[a0] = s02r + s13r;
                xi[a0] = s02i + s13i;
                xr[a1] = s02r - s13r;
                xi[a1] = s02i - s13i;
                rotate32x<2 * j * e>(xr[a1], xi[a1]);
                xr[a2] = d02r + d13r;
                xi[a2] = d02i + d13i;
                rotate32x<j * e>(xr[a2], xi[a2]);
                xr[a3] = d02r - d13r;
                xi[a3] = d02i - d13i;
                rotate32x<3 * j * e>(xr[a3], xi[a3]);
            });
        });
        if constexpr (kHalf >= 4) dif<N, kHalf / 4, kOff, M>(xr, xi);
    } else {
        static_for<N / 2>([&](auto blk) {
            constexpr int a = kOff + decltype(blk)::value * 2;
            const double dr = xr[a] - xr[a + 1], di = xi[a] - xi[a + 1];
            xr[a] += xr[a + 1];
            xi[a] += xi[a + 1];
            xr[a + 1] = dr;
            xi[a + 1] = di;
        });
    }
}

template <int N, int kOff, int M>
__device__ __forceinline__ void dft(double (&xr)[M], double (&xi)[M]) {
    dif<N, N / 2, kOff, M>(xr, xi);
}

// The window and twiddles are read per group (fmcw::ld_nc), not held in
// registers.
using fmcw::ld_nc;

// An int of magnitude below 2^31 as a double, exactly: the bits of 2^52 +
// 2^31 + v, minus 2^52 + 2^31 (one FP64 add; the conversion instruction
// runs at a quarter of the add's rate).
__device__ __forceinline__ double int_to_double(int v) {
    return __hiloint2double(0x43300000, (int)((unsigned)v ^ 0x80000000u)) -
           0x1.00000800p+52;
}

// rint(x * scale) clipped to int16, for a power-of-two scale and |x *
// scale| < 2^51: the product is exact, and adding 1.5 2^52 (ulp 1) rounds
// it half to even to an integer, which is the low word of the sum
// (fmcw::bfp_quantize's value).
__device__ __forceinline__ int quantize(double x, double scale) {
    const int v = __double2loint(fma(x, scale, 0x1.8p+52));
    return min(max(v, -32768), 32767);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: group gi's input (8 consecutive chirps, contiguous) into
// `buf`, completion counted on `bar`.
template <typename P>
__device__ __forceinline__ void prefetch(const uint32_t* iq, uint32_t* buf,
                                         uint64_t* bar, int gi) {
    const uint32_t b = smem_addr(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(P::kInBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(buf)), "l"(iq + (size_t)gi * P::kIn),
           "r"(P::kInBytes), "r"(b) : "memory");
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

// What a block shares: its shared-memory areas and the launch's arguments.
template <typename P>
struct Ctx {
    uint32_t* in;                       // input ring, kStages buffers
    double* xch;                        // exchange, two planes
    unsigned* peak_s;                   // [warp][chirp] peak keys
    int* sat_s;                         // [warp]
    uint64_t* bar;                      // [kStages]
    const uint32_t* iq;
    const int* win;
    const double2* tw;
    int* sat;
    int rnd, shift;
};

// The BFP peak as an integer key: the high word of |x| with its lowest bit
// set when the low word is not 0.  The key is monotone in |x|, so the
// largest key is the peak's, and it keeps what fmcw::bfp_scale reads: the
// exponent, and whether the mantissa is 0.  (Integer max, where fmax of
// doubles costs an FP64 compare a value.)
__device__ __forceinline__ unsigned abs_key(double x) {
    return ((unsigned)__double2hiint(x) & 0x7fffffffu) |
           (unsigned)(__double2loint(x) != 0);
}

// fmcw::bfp_scale(max(peak, 1)) from the peak's key: 2^-s, s = max(0,
// ceil(log2 peak) - 15).
__device__ __forceinline__ double scale_from_key(unsigned key) {
    if (key < 0x3ff00000u) return 1.0;          // peak < 1
    const int cl2 = (int)(key >> 20) - 1023 + ((key & 0xfffffu) != 0);
    const int s = cl2 > 15 ? cl2 - 15 : 0;
    return __longlong_as_double((long long)(1023 - s) << 52);
}

// The eighth-turn bins k = m n / 8, m odd, of a chirp (n >= 64: they lie
// in column 0 of pass 2, X[N1 kb] with kb = m N2 / 8, held by the thread
// with q = 0).  Column 0's rows Y[t] are exact integer sums (pass 1's ka =
// 0), and X[m n / 8] = sum_t Y[t] W_8^(t m) = u0 + u2 (-i)^m + u1 W_8^m + u3
// W_8^(3m), u_r = T_r - T_(r + 4), T_r = sum of the rows t = r (mod 8).
// Both W_8 terms are c (+-1 +-i), c = cos(pi / 4), so the bin is E + c P
// with E and P sums of integers, exact, and one FMA.  Where the input makes
// P = 0 the bin is an exact integer, as the golden model's, and its
// round-half ties fall the same way; the FFT's separate roundings of its c
// products need not cancel there.  re/im: the chirp's exchange region.
template <typename P>
__device__ __forceinline__ void eighth_turn_bins(double (&xr)[P::N1],
                                                 double (&xi)[P::N1],
                                                 const double* re,
                                                 const double* im) {
    double tr[8] = {}, ti[8] = {};
    static_for<P::N2>([&](auto tt) {
        constexpr int tp = decltype(tt)::value;
        constexpr int at = tp * P::N1 + (tp & (P::N1 - 1));   // column 0
        tr[tp % 8] += re[at];
        ti[tp % 8] += im[at];
    });
    static_for<4>([&](auto mm) {
        constexpr int m = 2 * decltype(mm)::value + 1;
        // W_8^k / c = a + i b for k odd; (-i)^m = -i g.
        constexpr int k1 = m % 8, k3 = 3 * m % 8;
        constexpr double a1 = k1 == 1 || k1 == 7 ? 1 : -1;
        constexpr double b1 = k1 == 5 || k1 == 7 ? 1 : -1;
        constexpr double a3 = k3 == 1 || k3 == 7 ? 1 : -1;
        constexpr double b3 = k3 == 5 || k3 == 7 ? 1 : -1;
        constexpr double g = m % 4 == 1 ? 1 : -1;
        const double u1r = tr[1] - tr[5], u1i = ti[1] - ti[5];
        const double u3r = tr[3] - tr[7], u3i = ti[3] - ti[7];
        const double pr = a1 * u1r - b1 * u1i + (a3 * u3r - b3 * u3i);
        const double pi = a1 * u1i + b1 * u1r + (a3 * u3i + b3 * u3r);
        const double er = (tr[0] - tr[4]) + g * (ti[2] - ti[6]);
        const double ei = (ti[0] - ti[4]) - g * (tr[2] - tr[6]);
        constexpr int p = bit_reverse(m * P::N2 / 8, P::kLog2N2);
        xr[p] = fma(kW32Re[4], pr, er);
        xi[p] = fma(kW32Re[4], pi, ei);
    });
}

// One group (8 chirps, input in `buf`, arrived when `bar` completes phase
// `parity`) through window, pass 1, exchange, pass 2 and the BFP peak:
// returns the thread's scale 2^-s with X[q + N2 j + N1 kb] of chirp c2 in
// x[j N2 + bit_reverse(kb)].  Two block barriers; after_b1() runs on thread
// 0 after the first, when `buf` has been read.
template <typename P, typename F>
__device__ __forceinline__ double transform_group(
        const Ctx<P>& cx, const uint32_t* buf, uint64_t* bar, uint32_t parity,
        int b, double (&xr)[P::N1], double (&xi)[P::N1], F&& after_b1) {
    constexpr int n = P::n, N1 = P::N1, N2 = P::N2;
    wait_parity(bar, parity);
    // The thread's indices, read anew each group: nothing derived from them
    // is held in registers across the loop.
    int tid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    const int lane = tid & 31, warp = tid >> 5;
    const int t = tid & (N2 - 1);                  // pass 1: lane t
    const int c1 = tid >> P::kLog2N2;              //   of chirp c1
    const int c2 = tid & (kChirps - 1);            // pass 2: chirp c2,
    const int q = tid / kChirps;                   //   columns q + N2 j

    // 1. Q15 window in integers: lane t takes samples t + N2 m of chirp c1;
    //    saturations summed by warp.
    {
        const uint32_t* src = buf + c1 * n + t;
        int nsat = 0;
        static_for<N1>([&](auto mm) {
            constexpr int m = decltype(mm)::value;
            const uint32_t w = src[N2 * m];
            const int c = ld_nc(cx.win + t + N2 * m);
            int si, sq;
            const int vi = fmcw::window_q15((int16_t)(w & 0xffffu), c, cx.rnd,
                                            cx.shift, &si);
            const int vq = fmcw::window_q15((int16_t)(w >> 16), c, cx.rnd,
                                            cx.shift, &sq);
            nsat += si + sq;
            xr[m] = int_to_double(vi);
            xi[m] = int_to_double(vq);
        });
        nsat = fmcw::warp_sum(nsat);
        if (lane == 0) cx.sat_s[warp] = nsat;
    }

    // 2. N1-point DFT over m, then W_n^(t ka) = tw[ka N2 + t].
    dft<N1, 0, N1>(xr, xi);
    static_for<N1 - 1>([&](auto kk) {
        constexpr int ka = decltype(kk)::value + 1;
        constexpr int p = bit_reverse(ka, P::kLog2N1);
        const double2 w = ld_nc(cx.tw + ka * N2 + t);
        const double r = fma(xr[p], w.x, -xi[p] * w.y);
        xi[p] = fma(xr[p], w.y, xi[p] * w.x);
        xr[p] = r;
    });

    // 3. Exchange across the block's chirps: row t of chirp c1's region,
    //    then columns q + N2 j.
    static_for<N1>([&](auto kk) {
        constexpr int ka = decltype(kk)::value;
        constexpr int p = bit_reverse(ka, P::kLog2N1);
        const int at = c1 * P::kRegion + t * N1 + ((ka + t) & (N1 - 1));
        cx.xch[at] = xr[p];
        cx.xch[P::kExchange + at] = xi[p];
    });
    __syncthreads();
    if (tid == 0) {
        int s = 0;
        for (int w = 0; w < P::kWarps; ++w) s += cx.sat_s[w];
        if (s) atomicAdd(cx.sat + b, s);
        after_b1();
    }
    static_for<N1>([&](auto i) {
        constexpr int j = decltype(i)::value / N2;
        constexpr int tp = decltype(i)::value % N2;
        const int at =
            c2 * P::kRegion + tp * N1 + ((q + N2 * j + tp) & (N1 - 1));
        xr[j * N2 + tp] = cx.xch[at];
        xi[j * N2 + tp] = cx.xch[P::kExchange + at];
    });

    // 4. N2-point DFTs over t'; column 0's eighth-turn bins exactly.
    static_for<N1 / N2>([&](auto jj) {
        constexpr int j = decltype(jj)::value;
        dft<N2, j * N2, N1>(xr, xi);
    });
    if constexpr (N2 >= 8) {
        if (q == 0)
            eighth_turn_bins<P>(xr, xi, cx.xch + c2 * P::kRegion,
                                cx.xch + P::kExchange + c2 * P::kRegion);
    }

    // 5. BFP exponent of chirp c2: the thread's peak, the max over the
    //    warp's lanes of the chirp (tid mod 8 = c2), then over warps.
    unsigned key = 0;
    static_for<N1>([&](auto i) {
        constexpr int k = decltype(i)::value;
        key = max(key, max(abs_key(xr[k]), abs_key(xi[k])));
    });
    key = max(key, __shfl_xor_sync(0xffffffffu, key, 8));
    key = max(key, __shfl_xor_sync(0xffffffffu, key, 16));
    if (lane < kChirps) cx.peak_s[warp * kChirps + c2] = key;
    __syncthreads();                    // peaks complete, regions free
    static_for<P::kWarps>([&](auto w) {
        key = max(key, cx.peak_s[decltype(w)::value * kChirps + c2]);
    });
    return scale_from_key(key);
}

// Quantizes the thread's values: store(row k, re, im) for each of its
// range rows k = q + N2 j + N1 kb.
template <typename P, typename F>
__device__ __forceinline__ void quantize_rows(const double (&xr)[P::N1],
                                              const double (&xi)[P::N1],
                                              double scale, F&& store) {
    static_for<P::N1>([&](auto i) {
        constexpr int j = decltype(i)::value / P::N2;
        constexpr int kb = decltype(i)::value % P::N2;
        constexpr int p = j * P::N2 + bit_reverse(kb, P::kLog2N2);
        store(P::N2 * j + P::N1 * kb, quantize(xr[p], scale),
              quantize(xi[p], scale));
    });
}

// kPairs (nd a multiple of 16): the block takes units of two groups, 16
// consecutive chirps, so that each range row's int16 values form whole
// 32-byte sectors.  The first group's quantized tile goes to its own input
// buffer (read by then), the second's to the exchange region (free after
// its second barrier); one barrier, then the block copies both tiles out,
// 16-byte vectors, two lanes a row: each warp instruction writes 16 rows x
// 32 bytes.  The buffers swap roles each unit: the second group's buffer
// takes the next unit's first copy at its first barrier, the first group's
// (after the copy-out) the next unit's second.  Else a unit is one group,
// stored straight from registers (16 bytes a row and plane).
template <int kLog2N, bool kPairs>
__global__ void __launch_bounds__(Plan<kLog2N>::kThreads, 1)
range_fft_fixed_kernel(const uint32_t* __restrict__ iq,
                       const int* __restrict__ win,
                       const double2* __restrict__ tw,
                       int16_t* __restrict__ out_re,
                       int16_t* __restrict__ out_im, int* __restrict__ sat,
                       int nd, int units, int rnd, int shift) {
    using P = Plan<kLog2N>;
    constexpr int n = P::n, N1 = P::N1;
    constexpr int kPer = kPairs ? 2 : 1;           // groups a unit
    extern __shared__ __align__(16) unsigned char smem[];
    const Ctx<P> cx{reinterpret_cast<uint32_t*>(smem),
                    reinterpret_cast<double*>(smem + P::kOffXch),
                    reinterpret_cast<unsigned*>(smem + P::kOffPeak),
                    reinterpret_cast<int*>(smem + P::kOffSat),
                    reinterpret_cast<uint64_t*>(smem + P::kOffBar),
                    iq, win, tw, sat, rnd, shift};
    const int per_frame = nd / (kChirps * kPer);   // units a frame

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem_addr(cx.bar + s)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        // Pairs: unit blockIdx.x's two groups.  Else: the first two units.
        for (int s = 0; s < kStages; ++s) {
            const int gi = kPairs ? 2 * blockIdx.x + s
                                  : blockIdx.x + s * gridDim.x;
            if (gi < units * kPer)
                prefetch<P>(iq, cx.in + s * P::kIn, cx.bar + s, gi);
        }
    }
    __syncthreads();

    int k = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int b = u / per_frame;
        const int c0 = (u - b * per_frame) * kChirps * kPer;
        const size_t frame = (size_t)b * n * nd;
        double xr[N1], xi[N1];
        if constexpr (kPairs) {
            const int x = k & 1;                   // the first group's buffer
            const int next = u + gridDim.x;
            unsigned char* const tile0 =
                reinterpret_cast<unsigned char*>(cx.in + x * P::kIn);
            unsigned char* const tile1 =
                reinterpret_cast<unsigned char*>(cx.xch) + P::kTileSkew;
            // The first group's tile goes to its own buffer; the second
            // group's buffer takes the next unit's first group.
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
                const int at = x ^ half;
                uint32_t* buf = cx.in + at * P::kIn;
                const double scale = transform_group(
                    cx, buf, cx.bar + at, k & 1, b, xr, xi, [&] {
                        if (half == 1 && next < units) {
                            asm volatile("fence.proxy.async.shared::cta;"
                                         ::: "memory");
                            prefetch<P>(iq, buf, cx.bar + at, 2 * next);
                        }
                    });
                int tid;
                asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
                int16_t* tile = reinterpret_cast<int16_t*>(half ? tile1
                                                                : tile0) +
                                (tid / kChirps) * kChirps +
                                (tid & (kChirps - 1));
                quantize_rows<P>(xr, xi, scale, [&](int row, int re, int im) {
                    tile[row * kChirps] = (int16_t)re;
                    tile[(n + row) * kChirps] = (int16_t)im;
                });
            }
            __syncthreads();
            // Copy-out: vector v = (plane row r2, half h), 16 bytes each.
            int tid;
            asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
            static_for<N1 / 2>([&](auto i) {
                const int v = decltype(i)::value * P::kThreads + tid;
                const int h = v & 1, r2 = v >> 1;
                const uint4 val = *reinterpret_cast<const uint4*>(
                    (h ? tile1 : tile0) + r2 * 16);
                int16_t* out = r2 < n ? out_re : out_im;
                *reinterpret_cast<uint4*>(
                    out + frame + (size_t)(r2 & (n - 1)) * nd + c0 +
                    h * kChirps) = val;
            });
            __syncthreads();
            if (tid == 0 && next < units) {
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                prefetch<P>(iq, cx.in + x * P::kIn, cx.bar + x, 2 * next + 1);
            }
        } else {
            const int stage = k % kStages;
            uint32_t* buf = cx.in + stage * P::kIn;
            const double scale = transform_group(
                cx, buf, cx.bar + stage, (k / kStages) & 1, b, xr, xi, [&] {
                    const int next = u + kStages * (int)gridDim.x;
                    if (next < units) {
                        asm volatile("fence.proxy.async.shared::cta;"
                                     ::: "memory");
                        prefetch<P>(iq, buf, cx.bar + stage, next);
                    }
                });
            int tid;
            asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
            // Each warp instruction: 4 range rows x 8 consecutive chirps.
            const size_t base = frame + c0 + (tid & (kChirps - 1)) +
                                (size_t)(tid / kChirps) * nd;
            quantize_rows<P>(xr, xi, scale, [&](int row, int re, int im) {
                out_re[base + (size_t)row * nd] = (int16_t)re;
                out_im[base + (size_t)row * nd] = (int16_t)im;
            });
        }
    }
}

// Launches at most one block per resident slot (blocks per SM x SMs): each
// walks its units through the input ring.  The shared-memory attribute and
// the slot count are set once per process and device.
template <int kLog2N, bool kPairs>
cudaError_t launch_n(const void* iq, const void* win, const void* tw,
                     void* out_re, void* out_im, void* sat, int batch,
                     int nd, int rnd, int shift, cudaStream_t stream) {
    using P = Plan<kLog2N>;
    auto* kernel = range_fft_fixed_kernel<kLog2N, kPairs>;
    static int slots[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (slots[dev] == 0) {
        int sms = 0, per_sm = 0;
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            P::kSmemBytes);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, P::kThreads, P::kSmemBytes);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        slots[dev] = per_sm * sms;
    }
    const int units = batch * (nd / (kPairs ? 2 * kChirps : kChirps));
    const int grid = units < slots[dev] ? units : slots[dev];
    kernel<<<grid, P::kThreads, P::kSmemBytes, stream>>>(
        static_cast<const uint32_t*>(iq), static_cast<const int*>(win),
        static_cast<const double2*>(tw), static_cast<int16_t*>(out_re),
        static_cast<int16_t*>(out_im), static_cast<int*>(sat), nd, units,
        rnd, shift);
    return cudaGetLastError();
}

int log2_exact(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return (1 << l) == n ? l : -1;
}

}  // namespace

// iq: int16 (batch, nd, n, 2), 16-byte aligned; win: int32 (n,) Q15
// coefficients; tw: complex float64 (n,) with tw[ka N2 + t] = exp(-2 pi i t
// ka / n) for the plan's n = N1 x N2 (ops/frontend_fixed._range_tables);
// out_re/out_im: int16 (batch, n, nd); sat: int32 (batch,), zeroed by the
// caller.  rnd/shift: the window's rounding constant and extraction shift.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fmcw_range_fft_fixed(const void* iq, const void* win,
                                    const void* tw, void* out_re,
                                    void* out_im, void* sat, int batch,
                                    int nd, int n, int rnd, int shift,
                                    void* stream) {
    const int log2n = log2_exact(n);
    if (batch < 1 || log2n < kMinLog2N || log2n > kMaxLog2N ||
        nd < kChirps || nd % kChirps != 0 ||
        (long long)batch * nd > 0x7fffffffLL || shift < 1 || shift > 30 ||
        ((reinterpret_cast<uintptr_t>(iq) |
          reinterpret_cast<uintptr_t>(out_re) |
          reinterpret_cast<uintptr_t>(out_im)) & 15))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    switch (log2n) {
#define FMCW_RANGE_FFT_FIXED_CASE(L)                                        \
    case L:                                                                 \
        err = nd % (2 * kChirps) == 0                                       \
                  ? launch_n<L, true>(iq, win, tw, out_re, out_im, sat,     \
                                      batch, nd, rnd, shift, s)             \
                  : launch_n<L, false>(iq, win, tw, out_re, out_im, sat,    \
                                       batch, nd, rnd, shift, s);           \
        break;
        FMCW_RANGE_FFT_FIXED_CASE(4)
        FMCW_RANGE_FFT_FIXED_CASE(5)
        FMCW_RANGE_FFT_FIXED_CASE(6)
        FMCW_RANGE_FFT_FIXED_CASE(7)
        FMCW_RANGE_FFT_FIXED_CASE(8)
        FMCW_RANGE_FFT_FIXED_CASE(9)
        FMCW_RANGE_FFT_FIXED_CASE(10)
#undef FMCW_RANGE_FFT_FIXED_CASE
    }
    return (int)err;
}
