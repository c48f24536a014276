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
//
// The lengths n = n2 x 128 beyond the powers of two (384, 640, ..., 1920
// and 2048: JAX's _ct_split, frontend_pallas.py:78-91) run as n = kO x m,
// m = 2^k the plan above and kO = 2 (2048) or the odd factor 3 .. 15 (kernel
// A's split, ops/frontend.range_fft_split).  A dense kO-point stage comes
// first (decimation in frequency): for each output class k2 < kO,
//   y[i1] = W_n^(i1 k2) sum_{i2 < kO} w x[i1 + m i2] W_kO^(i2 k2),  i1 < m,
// in FP64 from the table's exact twiddles64(n) values, and the m-point plan
// of y gives X[kO k1 + k2].  As in kernel A the block runs its group's
// classes kSlices at once (about 256 threads, one exchange region each) in
// kRounds rounds.  What differs from kernel A:
//  * the Q15 window is applied once, in place in the input buffer, right
//    after the copy lands (each sample windowed and its saturations counted
//    once, not once a class); the windowed values are int16 by construction;
//  * BFP takes the peak over all n bins of a chirp, so no class can be
//    quantized before every class is done.  A group's FP64 spectrum (8
//    chirps x n x 16 B, 256 KiB at 2048) does not fit a block, so the group
//    runs two sweeps of its classes: the first only takes the peak, the
//    second recomputes each class, quantizes and stores it straight from
//    registers (row kO k1 + k2, 4 rows x 8 chirps a warp instruction).
//    That is twice the FP64 work of one sweep, chosen over a scratch
//    spectrum in global memory for being simple and using no memory beyond
//    the block's; the paired store is the powers of two's only;
//  * the exact bins.  Every quarter- and eighth-turn bin k = j n / 8 is a
//    multiple of kO, so it lies in class 0, whose dense stage is a sum of
//    integers (W = 1): the m-point plan's exact paths above carry over.
//    Where 3 divides n (384, 768, 1152, 1536, 1920) the sixth- and
//    twelfth-turn bins k = j n / 12 (j not a multiple of 3) fall in classes
//    kO / 3 and 2 kO / 3, which irrational twiddles reach; they are computed
//    from the exact class sums of the windowed chirp (twelfth_bins, the
//    twin's ops/fft._twelfth_turn_bins) and replace the transform's values
//    in both sweeps;
//  * one input buffer where two do not fit under 196 KiB (1536 and 2048):
//    the next group's copy starts when the second sweep's last round has
//    read the buffer.
// The bound at these lengths: the dense stage is kO complex FMAs a sample
// and class, so at kO = 15 the FP64 pipe, not HBM, sets the time (the
// function's least work, 5 n log2 n a chirp, is what the bound counts).
// tests/test_torch_fixed_range_lengths.py models this plan in numpy, bit
// for bit against the plain twin.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "fixed_point.cuh"

namespace {

constexpr int kChirps = 8;      // chirps per group, a block's unit of work
constexpr int kMinLog2N = 4;    // the powers of two 16 ..
constexpr int kMaxLog2N = 10;   //   .. 1024
constexpr int kSlice = 128;     // JAX's lane slice: n = n2 x kSlice,
constexpr int kMaxSlices = 16;  //   n2 <= kMaxSlices
constexpr int kSmemCap = 200704;   // 196 KiB: the carve-out leaves L1 60 KB

// sqrt(3)/2 rounded to nearest (ops/fft.C3; cos(pi / 6) in libm is one ulp
// above it).
constexpr double kC3 = 0x1.bb67ae8584caap-1;

// W_12^j = cos(pi j / 6) - i sin(pi j / 6), its cos and sin each written
// c2 / 2 + c3 sqrt(3)/2: {c2 of the cos, c3 of the cos, c2 of the sin, c3
// of the sin} (ops/fft.W12_PARTS).
__constant__ int4 kW12[12] = {
    {2, 0, 0, 0},  {0, 1, 1, 0},   {1, 0, 0, 1},   {0, 0, 2, 0},
    {-1, 0, 0, 1}, {0, -1, 1, 0},  {-2, 0, 0, 0},  {0, -1, -1, 0},
    {-1, 0, 0, -1}, {0, 0, -2, 0}, {1, 0, 0, -1},  {0, 1, -1, 0}};

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

// The factorisation, launch shape and shared memory for n = kO x 2^kLog2M.
template <int kLog2M, int kO = 1>
struct Plan {
    static constexpr int m = 1 << kLog2M;            // the radix-2 transform
    static constexpr int n = kO * m;                 // samples a chirp
    static constexpr int kLog2N2 = kLog2M / 2;
    static constexpr int N2 = 1 << kLog2N2;          // lanes per chirp
    static constexpr int N1 = m / N2;                // points per lane
    static constexpr int kLog2N1 = kLog2M - kLog2N2;
    static constexpr int kLanes = kChirps * N2;      // one transform's threads
    // kO > 1: the classes k2 < kO in kRounds rounds of kSlices transforms
    // at once, at most 256 threads, the rounds as even as they go (kernel
    // A's rule).
    static constexpr int kMostSlices = kLanes >= 256 ? 1 : 256 / kLanes;
    static constexpr int kRounds = (kO + kMostSlices - 1) / kMostSlices;
    static constexpr int kSlices = (kO + kRounds - 1) / kRounds;
    static constexpr int kThreads = kSlices * kLanes;
    static constexpr int kWarps = kThreads / 32;
    // A chirp's exchange region in doubles: N2 rows (t) of N1 columns
    // (ka), column ka of row t stored at (ka + t) mod N1, and the region
    // padded to 2 (mod 16): at m = 1024 pass 1's half-warp (16 rows) and
    // pass 2's (8 chirps x 2 columns) then hit 16 distinct 8-byte bank
    // pairs, with no padded rows (which would take shared memory past 196
    // KB, where the carve-out leaves L1 28 KB for the window and twiddles
    // instead of 60 KB).
    static constexpr int kRegion = m + (18 - m % 16) % 16;
    static constexpr int kExchange = kChirps * kRegion;   // one plane
    static constexpr int kIn = kChirps * n;          // 32-bit I/Q words
    static constexpr int kInBytes = kIn * 4;
    // A group's quantized tile: [plane][range row][8 chirps] int16, the
    // size of an input buffer.  The second group of a pair keeps its tile
    // in the exchange region, kTileSkew bytes in (the copy-out's 16-byte
    // reads of the two tiles then fall in different banks).
    static constexpr int kTileSkew = 64;
    // After the input ring: the exchange planes of each slice, per-warp
    // peaks and saturation counts, the exact sixth- and twelfth-turn bins
    // (kO a multiple of 3: [chirp][j] double2, j < 12), the ring's
    // mbarriers.
    static constexpr int kOffPeakR = 2 * kSlices * kExchange * 8;
    static constexpr int kOffExactR = kOffPeakR + kWarps * kChirps * 4;
    static constexpr int kExactBytes = kO % 3 == 0 ? kChirps * 12 * 16 : 0;
    static constexpr int kOffSatR = kOffExactR + kExactBytes;
    static constexpr int kOffBarR = kOffSatR + ((kWarps * 4 + 15) / 16) * 16;
    static constexpr int kRest = kOffBarR + 2 * 8;
    // Input ring: two buffers, or one where two do not fit under kSmemCap
    // (kO > 1 only: 1536 and 2048).
    static constexpr int kStages =
        kO == 1 || 2 * kInBytes + kRest <= kSmemCap ? 2 : 1;
    static constexpr int kOffXch = kStages * kInBytes;
    static constexpr int kOffPeak = kOffXch + kOffPeakR;
    static constexpr int kOffExact = kOffXch + kOffExactR;
    static constexpr int kOffSat = kOffXch + kOffSatR;
    static constexpr int kOffBar = kOffXch + kOffBarR;
    static constexpr int kSmemBytes = kOffBar + kStages * 8;
    static_assert(kO > 1 || kTileSkew + kInBytes <= 2 * kExchange * 8,
                  "a tile fits in the exchange region");
    static_assert(kSmemBytes <= kSmemCap, "a group does not fit a block");
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
    uint32_t* in;                       // input ring, P::kStages buffers
    double* xch;                        // exchange, two planes
    unsigned* peak_s;                   // [warp][chirp] peak keys
    int* sat_s;                         // [warp]
    uint64_t* bar;                      // [P::kStages]
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

// ---------------------------------------------------------------------------
// n = kO x m, kO > 1: the dense kO-point stage before the m-point plan
// ---------------------------------------------------------------------------

// The group's 8 chirps windowed in place: each 32-bit I/Q word of `buf`
// becomes its windowed (I, Q), int16 by construction (window_q15 clips),
// the saturations summed by warp into shared memory: each sample once.
// Every thread then fences its writes against the next bulk copy into
// `buf` (the async proxy).
template <typename P>
__device__ __forceinline__ void window_in_place(const Ctx<P>& cx,
                                                uint32_t* buf, int tid) {
    int nsat = 0;
#pragma unroll 4
    for (int w = tid; w < P::kIn; w += P::kThreads) {
        const uint32_t v = buf[w];
        const int c = ld_nc(cx.win + w % P::n);
        int si, sq;
        const int vi = fmcw::window_q15((int16_t)(v & 0xffffu), c, cx.rnd,
                                        cx.shift, &si);
        const int vq = fmcw::window_q15((int16_t)(v >> 16), c, cx.rnd,
                                        cx.shift, &sq);
        nsat += si + sq;
        buf[w] = ((uint32_t)vi & 0xffffu) | ((uint32_t)vq << 16);
    }
    nsat = fmcw::warp_sum(nsat);
    if ((tid & 31) == 0) cx.sat_s[tid >> 5] = nsat;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The bins k = j n / 12 (j < 12 not a multiple of 3: the sixth and twelfth
// turns) of each chirp of the group, exactly, from its windowed samples in
// `buf` (ops/fft._twelfth_turn_bins): with T_r the samples s = r (mod 12)
// summed, X = sum_r T_r W_12^(r j) = E / 2 + (sqrt(3)/2) B, E and B sums of
// integers (below 2^28 at n = 1920), then E / 2 + RN(kC3 B) in FP64, the
// twin's operations, into exact[chirp][j].  Where B is 0 the part is
// the half-integer E / 2, a round-half tie of the BFP scaling that the
// transform's rounded twiddles need not give exactly.  Warp w takes chirps
// w, w + kWarps, ...: lane l < 12 sums the class r = l, then computes bin
// j = l (slowtime_detect_fixed.cu's twelfth_bins over a chirp).
template <typename P>
__device__ __forceinline__ void twelfth_bins(const uint32_t* buf,
                                             double2* exact, int tid) {
    const int l = tid & 31;
    for (int c = tid >> 5; c < kChirps; c += P::kWarps) {
        int tr = 0, ti = 0;
        if (l < 12) {
            for (int s = l; s < P::n; s += 12) {
                const uint32_t v = buf[c * P::n + s];
                tr += (int16_t)(v & 0xffffu);
                ti += (int16_t)(v >> 16);
            }
        }
        int er = 0, ei = 0, br = 0, bi = 0;
        for (int r = 0; r < 12; ++r) {
            const int a = __shfl_sync(0xffffffffu, tr, r);
            const int b = __shfl_sync(0xffffffffu, ti, r);
            const int4 w = kW12[(r * l) % 12];
            er += w.x * a + w.z * b;
            ei += w.x * b - w.z * a;
            br += w.y * a + w.w * b;
            bi += w.y * b - w.w * a;
        }
        if (l < 12 && l % 3 != 0)
            exact[c * 12 + l] = make_double2(
                __dadd_rn(0.5 * (double)er, __dmul_rn(kC3, (double)br)),
                __dadd_rn(0.5 * (double)ei, __dmul_rn(kC3, (double)bi)));
    }
}

// Class k2 of the group on the threads of slice s (l: the thread's lane in
// the slice): the dense stage over the windowed input `buf` into pass 1's
// points, the m-point plan's pass 1, the exchange through the slice's
// regions, pass 2, then the exact bins (class 0's eighth turns, from
// column 0 as for the powers of two; the sixth and twelfth turns from
// `exact`).  X[kO (q + N2 j + N1 kb) + k2] of chirp c2 lands in x[j N2 +
// bit_reverse(kb)].  Two block barriers, which every thread passes
// (`active`: the slice has a class this round); after_b1() runs on thread 0
// after the first.
template <typename P, typename F>
__device__ __forceinline__ void class_transform(
        const Ctx<P>& cx, const uint32_t* buf, const double2* exact, int k2,
        bool active, int s, int l, double (&xr)[P::N1], double (&xi)[P::N1],
        F&& after_b1) {
    constexpr int m = P::m, n = P::n, N1 = P::N1, N2 = P::N2;
    constexpr int kO = n / m;
    const int t = l & (N2 - 1);                    // pass 1: lane t
    const int c1 = l >> P::kLog2N2;                //   of chirp c1
    const int c2 = l & (kChirps - 1);              // pass 2: chirp c2,
    const int q = l / kChirps;                     //   columns q + N2 j
    double* const xch = cx.xch + s * 2 * P::kExchange;
    if (active) {
        // 1. The dense stage: point i1 = t + N2 m' sums its kO windowed
        //    samples i1 + m i2 times W_kO^(i2 k2) = tw[m + n + i2 k2 mod
        //    kO], then takes W_n^(i1 k2) = tw[m + k2 m + i1].  Class 0
        //    multiplies by exactly 1: a sum of integers.
        const double2* twn = cx.tw + m + k2 * m + t;
        const double2* two = cx.tw + m + n;
        double cr[kO], ci[kO];
        static_for<kO>([&](auto ii) {
            constexpr int i2 = decltype(ii)::value;
            const double2 w = ld_nc(two + i2 * k2 % kO);
            cr[i2] = w.x;
            ci[i2] = w.y;
        });
        const uint32_t* src = buf + c1 * n + t;
        static_for<N1>([&](auto mm) {
            constexpr int mv = decltype(mm)::value;
            double ar = 0.0, ai = 0.0;
            static_for<kO>([&](auto ii) {
                constexpr int i2 = decltype(ii)::value;
                const uint32_t v = src[N2 * mv + m * i2];
                const double r = int_to_double((int16_t)(v & 0xffffu));
                const double im = int_to_double((int16_t)(v >> 16));
                ar = fma(r, cr[i2], ar);
                ar = fma(-im, ci[i2], ar);
                ai = fma(r, ci[i2], ai);
                ai = fma(im, cr[i2], ai);
            });
            const double2 w = ld_nc(twn + N2 * mv);
            xr[mv] = fma(ar, w.x, -ai * w.y);
            xi[mv] = fma(ar, w.y, ai * w.x);
        });
        // 2. N1-point DFT over m', then W_m^(t ka) = tw[ka N2 + t].
        dft<N1, 0, N1>(xr, xi);
        static_for<N1 - 1>([&](auto kk) {
            constexpr int ka = decltype(kk)::value + 1;
            constexpr int p = bit_reverse(ka, P::kLog2N1);
            const double2 w = ld_nc(cx.tw + ka * N2 + t);
            const double r = fma(xr[p], w.x, -xi[p] * w.y);
            xi[p] = fma(xr[p], w.y, xi[p] * w.x);
            xr[p] = r;
        });
        // 3. Exchange: row t of chirp c1's region.
        static_for<N1>([&](auto kk) {
            constexpr int ka = decltype(kk)::value;
            constexpr int p = bit_reverse(ka, P::kLog2N1);
            const int at = c1 * P::kRegion + t * N1 + ((ka + t) & (N1 - 1));
            xch[at] = xr[p];
            xch[P::kExchange + at] = xi[p];
        });
    }
    __syncthreads();
    int tid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
    if (tid == 0) after_b1();
    if (active) {
        static_for<N1>([&](auto i) {
            constexpr int j = decltype(i)::value / N2;
            constexpr int tp = decltype(i)::value % N2;
            const int at =
                c2 * P::kRegion + tp * N1 + ((q + N2 * j + tp) & (N1 - 1));
            xr[j * N2 + tp] = xch[at];
            xi[j * N2 + tp] = xch[P::kExchange + at];
        });
        // 4. N2-point DFTs over t'; the exact bins.
        static_for<N1 / N2>([&](auto jj) {
            constexpr int j = decltype(jj)::value;
            dft<N2, j * N2, N1>(xr, xi);
        });
        if (k2 == 0 && q == 0)
            eighth_turn_bins<P>(xr, xi, xch + c2 * P::kRegion,
                                xch + P::kExchange + c2 * P::kRegion);
        if constexpr (kO % 3 == 0) {
            // Bin k = j n / 12 is X_m[k1] of class k % kO, k1 = k / kO =
            // q + N2 jj + N1 kb.
            static_for<12>([&](auto jv) {
                constexpr int j = decltype(jv)::value;
                if constexpr (j % 3 != 0) {
                    constexpr int k = j * (n / 12), k1 = k / kO;
                    constexpr int p = (k1 / N2) % (N1 / N2) * N2 +
                                      bit_reverse(k1 / N1, P::kLog2N2);
                    if (k2 == k % kO && q == k1 % N2) {
                        const double2 e = exact[c2 * 12 + j];
                        xr[p] = e.x;
                        xi[p] = e.y;
                    }
                }
            });
        }
    }
    __syncthreads();                    // the regions are free again
}

// n = kO x m, kO > 1: a unit is one group of 8 chirps.  Per group: the
// window in place (its saturations into sat[b]), the exact sixth- and
// twelfth-turn bins (kO a multiple of 3), then the classes twice, in
// rounds of kSlices: the first sweep takes each thread's peak key, and the
// max over the chirp's lanes and the block's warps gives its scale; the
// second recomputes each class, quantizes it and stores it straight from
// registers, each warp instruction 4 range rows kO k1 + k2 x 8 consecutive
// chirps.
template <int kLog2M, int kO>
__global__ void __launch_bounds__(Plan<kLog2M, kO>::kThreads, 1)
range_fft_fixed_dense_kernel(const uint32_t* __restrict__ iq,
                             const int* __restrict__ win,
                             const double2* __restrict__ tw,
                             int16_t* __restrict__ out_re,
                             int16_t* __restrict__ out_im,
                             int* __restrict__ sat, int nd, int units,
                             int rnd, int shift) {
    using P = Plan<kLog2M, kO>;
    constexpr int n = P::n, N1 = P::N1;
    constexpr int kStages = P::kStages;
    extern __shared__ __align__(16) unsigned char smem[];
    const Ctx<P> cx{reinterpret_cast<uint32_t*>(smem),
                    reinterpret_cast<double*>(smem + P::kOffXch),
                    reinterpret_cast<unsigned*>(smem + P::kOffPeak),
                    reinterpret_cast<int*>(smem + P::kOffSat),
                    reinterpret_cast<uint64_t*>(smem + P::kOffBar),
                    iq, win, tw, sat, rnd, shift};
    double2* const exact = reinterpret_cast<double2*>(smem + P::kOffExact);
    const int per_frame = nd / kChirps;            // units a frame

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem_addr(cx.bar + s)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < kStages; ++s) {
            const int gi = blockIdx.x + s * gridDim.x;
            if (gi < units)
                prefetch<P>(iq, cx.in + s * P::kIn, cx.bar + s, gi);
        }
    }
    __syncthreads();

    int k = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
        const int b = u / per_frame;
        const int c0 = (u - b * per_frame) * kChirps;
        const int stage = k % kStages;
        uint32_t* buf = cx.in + stage * P::kIn;
        wait_parity(cx.bar + stage, (k / kStages) & 1);
        int tid;
        asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
        window_in_place<P>(cx, buf, tid);
        __syncthreads();
        if (tid == 0) {
            int s = 0;
            for (int w = 0; w < P::kWarps; ++w) s += cx.sat_s[w];
            if (s) atomicAdd(cx.sat + b, s);
        }
        if constexpr (kO % 3 == 0) twelfth_bins<P>(buf, exact, tid);
        unsigned key = 0;
        double scale = 1.0;
#pragma unroll 1
        for (int sweep = 0; sweep < 2; ++sweep) {
#pragma unroll 1
            for (int round = 0; round < P::kRounds; ++round) {
                // The thread's indices, read anew each round: nothing
                // derived from them is held in registers across the loop.
                asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
                const int s = P::kSlices == 1 ? 0 : tid / P::kLanes;
                const int l = tid & (P::kLanes - 1);
                const int k2 = round * P::kSlices + s;
                const bool active = k2 < kO;       // uniform in a slice
                double xr[N1], xi[N1];
                class_transform<P>(cx, buf, exact, k2, active, s, l, xr,
                                   xi, [&] {
                    // The second sweep's last round has read the buffer:
                    // it takes the copy kStages units on.
                    const int next = u + kStages * (int)gridDim.x;
                    if (sweep == 1 && round == P::kRounds - 1 &&
                        next < units) {
                        asm volatile("fence.proxy.async.shared::cta;"
                                     ::: "memory");
                        prefetch<P>(iq, buf, cx.bar + stage, next);
                    }
                });
                if (!active) continue;
                if (sweep == 0) {
                    static_for<N1>([&](auto i) {
                        constexpr int j = decltype(i)::value;
                        key = max(key, max(abs_key(xr[j]), abs_key(xi[j])));
                    });
                } else {
                    const size_t base = (size_t)b * n * nd + c0 +
                                        (l & (kChirps - 1)) +
                                        (size_t)(kO * (l / kChirps) + k2) * nd;
                    quantize_rows<P>(xr, xi, scale,
                                     [&](int row, int re, int im) {
                        const size_t at = base + (size_t)(kO * row) * nd;
                        out_re[at] = (int16_t)re;
                        out_im[at] = (int16_t)im;
                    });
                }
            }
            if (sweep == 0) {
                // The BFP exponent of chirp tid mod 8: the max over the
                // warp's lanes of the chirp, then over every slice's warps.
                asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
                key = max(key, __shfl_xor_sync(0xffffffffu, key, 8));
                key = max(key, __shfl_xor_sync(0xffffffffu, key, 16));
                if ((tid & 31) < kChirps)
                    cx.peak_s[(tid >> 5) * kChirps + (tid & 31)] = key;
                __syncthreads();
                static_for<P::kWarps>([&](auto w) {
                    key = max(key, cx.peak_s[decltype(w)::value * kChirps +
                                             (tid & (kChirps - 1))]);
                });
                scale = scale_from_key(key);
            }
        }
    }
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
    constexpr int kStages = P::kStages;
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

// The kernel of n = kO x 2^kLog2M: the powers of two's (kO = 1, paired or
// not), else the dense stage's.
template <int kLog2M, int kO, bool kPairs>
auto kernel_of() {
    if constexpr (kO == 1)
        return range_fft_fixed_kernel<kLog2M, kPairs>;
    else
        return range_fft_fixed_dense_kernel<kLog2M, kO>;
}

// Launches at most one block per resident slot (blocks per SM x SMs): each
// walks its units through the input ring.  The shared-memory attribute and
// the slot count are set once per process and device.
template <int kLog2M, int kO, bool kPairs>
cudaError_t launch_n(const void* iq, const void* win, const void* tw,
                     void* out_re, void* out_im, void* sat, int batch,
                     int nd, int rnd, int shift, cudaStream_t stream) {
    using P = Plan<kLog2M, kO>;
    auto* kernel = kernel_of<kLog2M, kO, kPairs>();
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

// The lengths the kernel takes: a power of two 2^kMinLog2N .. 2^kMaxLog2N,
// or n2 x kSlice with n2 <= kMaxSlices (kernel A's, range_fft.cu).
bool length_ok(int n) {
    const bool pow2 = n > 0 && (n & (n - 1)) == 0;
    return (pow2 && n >= (1 << kMinLog2N) && n <= (1 << kMaxLog2N)) ||
           (n > 0 && n % kSlice == 0 && n / kSlice <= kMaxSlices);
}

}  // namespace

// iq: int16 (batch, nd, n, 2), 16-byte aligned; win: int32 (n,) Q15
// coefficients; tw: complex float64, with n = kO x m (ops/frontend.
// range_fft_split) and m = N1 x N2: tw[ka N2 + t] = exp(-2 pi i t ka / m)
// (m entries), for kO > 1 followed by exp(-2 pi i i1 k2 / n) at [m + k2 m
// + i1] and exp(-2 pi i e / kO) at [m + n + e] (ops/frontend_fixed.
// _range_tables); out_re/out_im: int16 (batch, n, nd); sat: int32 (batch,),
// zeroed by the caller.  rnd/shift: the window's rounding constant and
// extraction shift.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fmcw_range_fft_fixed(const void* iq, const void* win,
                                    const void* tw, void* out_re,
                                    void* out_im, void* sat, int batch,
                                    int nd, int n, int rnd, int shift,
                                    void* stream) {
    if (batch < 1 || !length_ok(n) || nd < kChirps || nd % kChirps != 0 ||
        (long long)batch * nd > 0x7fffffffLL || shift < 1 || shift > 30 ||
        ((reinterpret_cast<uintptr_t>(iq) |
          reinterpret_cast<uintptr_t>(out_re) |
          reinterpret_cast<uintptr_t>(out_im)) & 15))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaErrorInvalidValue;
    // n = kO x 2^L (ops/frontend.range_fft_split).
    switch (n) {
#define FMCW_RANGE_FFT_FIXED_POW2(N, L)                                     \
    case N:                                                                 \
        err = nd % (2 * kChirps) == 0                                       \
                  ? launch_n<L, 1, true>(iq, win, tw, out_re, out_im, sat,  \
                                         batch, nd, rnd, shift, s)          \
                  : launch_n<L, 1, false>(iq, win, tw, out_re, out_im, sat, \
                                          batch, nd, rnd, shift, s);        \
        break;
#define FMCW_RANGE_FFT_FIXED_DENSE(N, L, O)                                 \
    case N:                                                                 \
        err = launch_n<L, O, false>(iq, win, tw, out_re, out_im, sat, batch, \
                                    nd, rnd, shift, s);                     \
        break;
        FMCW_RANGE_FFT_FIXED_POW2(16, 4)
        FMCW_RANGE_FFT_FIXED_POW2(32, 5)
        FMCW_RANGE_FFT_FIXED_POW2(64, 6)
        FMCW_RANGE_FFT_FIXED_POW2(128, 7)
        FMCW_RANGE_FFT_FIXED_POW2(256, 8)
        FMCW_RANGE_FFT_FIXED_POW2(512, 9)
        FMCW_RANGE_FFT_FIXED_POW2(1024, 10)
        FMCW_RANGE_FFT_FIXED_DENSE(384, 7, 3)
        FMCW_RANGE_FFT_FIXED_DENSE(640, 7, 5)
        FMCW_RANGE_FFT_FIXED_DENSE(768, 8, 3)
        FMCW_RANGE_FFT_FIXED_DENSE(896, 7, 7)
        FMCW_RANGE_FFT_FIXED_DENSE(1152, 7, 9)
        FMCW_RANGE_FFT_FIXED_DENSE(1280, 8, 5)
        FMCW_RANGE_FFT_FIXED_DENSE(1408, 7, 11)
        FMCW_RANGE_FFT_FIXED_DENSE(1536, 9, 3)
        FMCW_RANGE_FFT_FIXED_DENSE(1664, 7, 13)
        FMCW_RANGE_FFT_FIXED_DENSE(1792, 8, 7)
        FMCW_RANGE_FFT_FIXED_DENSE(1920, 7, 15)
        FMCW_RANGE_FFT_FIXED_DENSE(2048, 10, 2)
#undef FMCW_RANGE_FFT_FIXED_POW2
#undef FMCW_RANGE_FFT_FIXED_DENSE
    }
    return (int)err;
}
