// Angle-extended (3D) OS-CFAR detection by counting, on Hopper, for float32
// or int32 beam cubes.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_detect_3d (called through
// cfar_3d_pallas_detect): the decision of ops/cfar.cfar_3d with
// ref_angle > 0, whose training set is the 3D box of +-ha = +-(ref_angle +
// guard_angle) beam planes around the CUT minus the guard box on the planes
// within +-guard_angle, every axis wrapped (the beam axis too).  The
// adaptive scale is per cell whatever the CfarParams' scale mode, as in
// JAX's XLA body.
//
// In:  cube (B, A, R, D) int32 or float32 — or, prepadded, (B, A + 2 ha, R,
//      D): a beam shard with ha = ref_angle + guard_angle planes of its
//      neighbours on each side (the sharded array model's beam-halo
//      exchange, cfar_3d(prepadded_angle=True)); the beam axis then does not
//      wrap.  A scalar scale_override.
// Out: det (B, A, R, D) in the cube's type — the CUT where CUT > est * scale,
//      else 0 — and scale (B, A, R, D) int32, scale_override folded in; for
//      a prepadded shard, its A interior planes.
//
// Bound on an H100: operations — per training value and cell 3 compares
// and 3 counting adds (hi, lo, the decision), n_ref = 414 at the default
// window with ref_angle 1; the bytes are 12 per cell (the cube in, det and
// scale out).  The compares of a float cube are FSETs (1.0 / 0.0, one op on
// the integer pipe, half the FP32 lanes) and its counts add on the FMA pipe
// (cfar_tile.cuh), so the integer pipe's 3 ops per training value are the
// floor of this design.
//
// Design.  One block per (cube, beam plane, tile of T range rows), three
// blocks an SM (T = 16 at the default window: 67.6 KB of shared memory,
// registers capped at 80):
//   1. the 2 ha + 1 beam planes' T + 2 hr rows its windows reach (rows
//      wrapped modulo R; planes wrapped, or a prepadded shard's carried
//      planes) are copied into shared memory whole: each (plane, row) is D
//      contiguous words of the cube, one warp a row, 16-byte cp.async
//      copies where D and the cube allow (the plane and row computed once a
//      row, no division per element);
//   2. the planes' column sums over the window's 2 hr + 1 rows (rows
//      ascending), into shared memory;
//   3. a thread takes a strip of S = kStrip cells of one Doppler column
//      (cfar_tile.cuh's strips: threads of a warp on neighbouring columns;
//      a tile of T rows has ceil(T / S) strips, the last overlapping its
//      neighbour when S does not divide T).  Per cell the training-set sum
//      in the plain twin's order (planes ascending, in each the column sums
//      added dd ascending, then each guard cell of the |da| <= ga planes
//      subtracted, dd outer, dr inner; the strip's cells side by side, so
//      that their eight chains of dependent adds overlap), the thresholds;
//      then, for each plane, one walk per window column of its 2 hr + 1
//      rows through a ring of S registers (each value loaded once for the S
//      cells), the guard rows of the guard columns left out on the guard
//      planes only.  The (6, 2) and (3, 1) windows walk unrolled, and with
//      D = 128 (the repository's maps) the row pitch is a compile-time
//      constant, so every shared-memory offset of a walk is an immediate.
//      The hi/lo pass counts hi and lo in one packed count (float: hi *
//      4096 + lo, exact while n_ref <= 4094; int: hi * 65536 + lo, n_ref <=
//      32767), else in two counts; a float cube counts in float (FSET and
//      an add on the FMA pipe), an int32 cube in int (its values span all
//      of int32).  The decision pass counts refs >= q (cfar_common.cuh's
//      detect_threshold); a scale override skips the hi/lo pass.
// A tile too large for strips of 8 (T < 8 rows fit in shared memory) takes
// S = 1, a cell a thread.  Decisions and scales are bit-identical to
// ops/cfar.cfar_3d on the same cube; tests/test_torch_cfar3d_plan.py holds a
// numpy model of this plan against it.
//
// The reflect entry (reflect = 1, CfarParams.edge_mode="reflect") is
// _kernel_detect_3d on the cube that JAX's wrapper pads with numpy's
// "reflect" on all three axes (cfar_pallas.py:739-744; the beam axis not,
// for a prepadded shard, whose halo planes the exchange mirrored).  Only
// step 1 changes: it copies beam plane reflect(a - ha + p) (a prepadded
// shard's plane a + p), its rows reflect(r0 - hr + e), each with its hd
// mirrored columns on each side, tile column j holding cube column
// reflect(j - hd): rows of pitch D + 2 hd (138 at the default window, a
// compile-time constant there).  Steps 2-3 then read the tile without a
// column wrap (column sums over every column of the pitch; cfar_tile.cuh's
// walks with kWrap false), in the same order, so the decisions and scales
// are bit-identical to ops/cfar.cfar_3d on the mirrored cube.  JAX's kernel
// sums a reflect window in offset order (its direct loop, :624-627); the
// port keeps its separable order on the mirrored cube, so float means may
// differ from JAX's in their last bits (integer sums are exact).  A single
// mirror: ha < A (whole cubes) and hr < R, hd < D.
//
// Column chunks (W < D: planes wider than a tile of whole rows fits, at the
// repository's window above 1376 / 824 / 592 columns with 3 / 5 / 7 beam
// planes; the model of the decide kernel, slowtime_long.cuh).  A block
// takes T rows x a chunk of W columns of its 2 ha + 1 planes at the
// reflect entry's layout: tile rows of W + 2 hd cells from map column c0 -
// hd, wrapped modulo D or mirrored (fmcw::chunk_col), so that the windows
// of its T x W cells lie in the tile unwrapped; steps 2-3 run as for the
// reflect entry (the column sums of the same columns, added in the same
// order), so decisions and scales are the whole-row tile's bit for bit.
// It stores the columns of its chunk below D.  Whole rows (W = D: the wrap
// and reflect entries) keep their code and launches
// (ops/cfar3d_detect.tile_plan picks W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"

// Mirrors Cfar3dConfig in kernels.py (ctypes.Structure, all int32).
struct Cfar3dConfig {
    int batch, A, R, D, T;
    int ha, ga;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int so, integer, prepadded;
    int strip, packed;
    int reflect;    // numpy's "reflect" edges (the beam axis too unless
                    // prepadded)
    int W;          // columns a block decides: D, or a chunk of them
};

namespace {

constexpr int kThreads = 256;
// Three blocks an SM: the registers capped at 80 a thread (as the default
// window's T = 16 tile, 67.6 KB, allows three in shared memory).
constexpr int kBlocksPerSM = 3;
constexpr int kMaxPackedInt = 32767;   // hi * 65536 + lo stays below 2^31

// Do the tile's rows carry their column halo: the reflect entry and
// column chunks.
__host__ __device__ inline bool halo(const Cfar3dConfig& c) {
    return c.reflect || c.W < c.D;
}

// The tile's row pitch: D, or W + 2 hd where the rows carry their column
// halo (D + 2 hd for the reflect entry's whole rows).
__host__ __device__ inline int pitch(const Cfar3dConfig& c) {
    return halo(c) ? c.W + 2 * c.hd : c.D;
}

__host__ __device__ inline size_t smem_elems(const Cfar3dConfig& c) {
    const int np = 2 * c.ha + 1;
    const int P = pitch(c);
    return (size_t)np * (c.T + 2 * c.hr) * P + (size_t)np * c.T * P;
}

// kD: the tile's row pitch at compile time (0: at run time); kReflect: the
// reflect entry's whole rows (mirrored planes, rows and column halo;
// columns read unwrapped); kChunk: a column chunk (its rows carry their
// column halo, wrapped or, with c.reflect, mirrored with the planes and
// rows; columns read unwrapped).
template <typename V, int S, int HR, int GR, bool kPacked, int kD,
          bool kReflect, bool kChunk>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cfar3d_detect_kernel(const V* __restrict__ cube, V* __restrict__ det,
                     int* __restrict__ scale_out, const Cfar3dConfig c) {
    using Sem = fmcw::MapSem<V>;
    using Cnt = fmcw::Count<V>;
    extern __shared__ int4 smem_v4[];
    const int np = 2 * c.ha + 1;
    const int T = c.T;
    constexpr bool kHalo = kReflect || kChunk;
    const int P = kD > 0 ? kD : pitch(c);  // the tile's row pitch
    // The columns decided, and the map's (D = P: at compile time with kD).
    const int D = kChunk ? c.W : (kReflect ? c.D : P);
    const int DM = kChunk ? c.D : D;
    const int off = kHalo ? c.hd : 0;      // tile column of column 0
    // Tile column of window column d + dd: unwrapped where the rows carry
    // their halo, else modulo D.
    auto wcol = [&](int d, int dd) {
        return kHalo ? off + d + dd : fmcw::wrap_col(d + dd, D);
    };
    const int E = T + 2 * c.hr;
    V* tile = reinterpret_cast<V*>(smem_v4);      // np planes x E rows x P
    V* cs = tile + (size_t)np * E * P;            // np planes x T rows x P
    // blockIdx.x walks the chunks of a tile of rows, then the tiles; the
    // decided column d is map column c0 + d.
    const int n_chunks = kChunk ? (c.D + c.W - 1) / c.W : 1;
    const int r0 = (kChunk ? (int)(blockIdx.x / n_chunks) : blockIdx.x) * T;
    const int c0 = kChunk ? (int)(blockIdx.x % n_chunks) * c.W : 0;
    const int a = blockIdx.y;
    const int b = blockIdx.z;

    // 1. The planes' rows r0 - hr .. r0 + T + hr - 1, a warp a row (the
    //    reflect entry: mirrored, each with its mirrored column halo; a
    //    chunk: its columns c0 - hd .., wrapped or mirrored; by 4-byte
    //    copies, as rows of W + 2 hd cells put the cube's columns off a
    //    16-byte boundary).
    {
        const int a_in = c.prepadded ? c.A + 2 * c.ha : c.A;
        const bool vec = !kHalo && (D & 3) == 0 &&
                         ((uintptr_t)cube & 15) == 0;
        const bool refl = kChunk ? c.reflect : kReflect;
        const int lane = threadIdx.x & 31;
        for (int row = threadIdx.x >> 5; row < np * E;
             row += kThreads / 32) {
            const int p = row / E;
            const int e = row - p * E;
            const int plane =
                c.prepadded ? a + p
                            : (refl ? fmcw::reflect_mod(a - c.ha + p, c.A)
                                    : fmcw::wrap_mod(a - c.ha + p, c.A));
            const int mrow = refl ? fmcw::reflect_mod(r0 - c.hr + e, c.R)
                                  : fmcw::wrap_mod(r0 - c.hr + e, c.R);
            const V* src =
                cube + (((size_t)b * a_in + plane) * c.R + mrow) * DM;
            V* dst = tile + (size_t)row * P;
            if constexpr (kChunk) {
                for (int j = lane; j < P; j += 32)
                    fmcw::cp_async4(
                        dst + j,
                        src + fmcw::chunk_col(c0 - c.hd + j, c.D, refl));
            } else if constexpr (kReflect) {
                for (int j = lane; j < P; j += 32)
                    fmcw::cp_async4(dst + j,
                                    src + fmcw::mirror_col(j - c.hd, c.D));
            } else if (vec) {
                for (int i = 4 * lane; i < D; i += 128)
                    fmcw::cp_async16(dst + i, src + i);
            } else {
                for (int i = lane; i < D; i += 32)
                    fmcw::cp_async4(dst + i, src + i);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    }
    __syncthreads();

    const int units = (T + S - 1) / S * D;       // strips x columns
    // 2. Column sums over the window's rows, rows ascending (from -0, which
    //    adds as taking the first value), a strip at a time, over every
    //    column of the tile's rows.
    const int cs_units = (T + S - 1) / S * P;
    for (int u = threadIdx.x; u < np * cs_units; u += kThreads) {
        const int p = u / cs_units;
        const int st = (u - p * cs_units) / P;
        const int d = u - p * cs_units - st * P;
        const int i0 = min(st * S, T - S);
        V f[S];
#pragma unroll
        for (int s = 0; s < S; ++s) f[s] = fmcw::sum_identity<V>();
        const V* col = tile + ((size_t)p * E + i0) * P + d;
        auto add = [&](int, int s, V v) { f[s] = fmcw::vadd(f[s], v); };
        if constexpr (HR > 0)
            fmcw::walk_rows_fixed<S, HR, GR, false>(col, P, add);
        else
            fmcw::walk_rows<S>(col, P, 2 * c.hr + 1,
                               [](int) { return true; }, add);
#pragma unroll
        for (int s = 0; s < S; ++s)
            cs[((size_t)p * T + i0 + s) * P + d] = f[s];
    }
    __syncthreads();

    // 3. The strips' decisions.
    const fmcw::CfarGeom g{c.hr, c.hd, c.gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    const int g_lo = c.ha - c.ga, g_hi = c.ha + c.ga;    // guard planes
    const int rows_out = min(T, c.R - r0);               // rows stored
    for (int u = threadIdx.x; u < units; u += kThreads) {
        const int st = u / D;
        const int d = u - st * D;
        const int i0 = min(st * S, T - S);
        int sc[S];
        if (c.so != 0) {
#pragma unroll
            for (int s = 0; s < S; ++s) sc[s] = c.so;
        } else {
            // Training-set sums (each cell's terms in the twin's order, the
            // strip's cells side by side) and the thresholds.
            V sum[S], t_hi[S], t_lo[S];
#pragma unroll
            for (int s = 0; s < S; ++s) sum[s] = fmcw::sum_identity<V>();
            for (int p = 0; p < np; ++p) {
                const V* row = cs + ((size_t)p * T + i0) * P;
                for (int dd = -c.hd; dd <= c.hd; ++dd) {
                    const V* col = row + wcol(d, dd);
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        sum[s] = fmcw::vadd(sum[s], col[s * P]);
                }
            }
            for (int p = g_lo; p <= g_hi; ++p) {
                const V* row = tile + ((size_t)p * E + i0 + c.hr) * P;
                for (int dd = -c.gd; dd <= c.gd; ++dd) {
                    const V* col = row + wcol(d, dd);
                    for (int dr = -c.gr; dr <= c.gr; ++dr) {
#pragma unroll
                        for (int s = 0; s < S; ++s)
                            sum[s] = fmcw::vsub(sum[s], col[(s + dr) * P]);
                    }
                }
            }
#pragma unroll
            for (int s = 0; s < S; ++s)
                Sem::thresholds(sum[s], c.n_ref, t_hi[s], t_lo[s]);
            // The hi/lo classification counts.
            if constexpr (kPacked) {
                Cnt hl[S];
#pragma unroll
                for (int s = 0; s < S; ++s) hl[s] = 0;
                for (int p = 0; p < np; ++p)
                    fmcw::walk_window_t<S, HR, GR, !kHalo>(
                        tile + ((size_t)p * E + i0) * P + off, P, d, g,
                        p >= g_lo && p <= g_hi, [&](int, int s, V v) {
                            hl[s] = fmcw::count_hi_lo(hl[s], v, t_hi[s],
                                                      t_lo[s]);
                        });
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    int hi, lo;
                    fmcw::unpack_hi_lo(hl[s], hi, lo);
                    sc[s] = fmcw::classify(hi, lo, c.k, g);
                }
            } else {
                Cnt hi[S], lo[S];
#pragma unroll
                for (int s = 0; s < S; ++s) hi[s] = lo[s] = 0;
                for (int p = 0; p < np; ++p)
                    fmcw::walk_window_t<S, HR, GR, !kHalo>(
                        tile + ((size_t)p * E + i0) * P + off, P, d, g,
                        p >= g_lo && p <= g_hi, [&](int, int s, V v) {
                            hi[s] = fmcw::count_add(
                                hi[s], fmcw::is_gt(v, t_hi[s]));
                            lo[s] = fmcw::count_add(
                                lo[s], fmcw::is_ge(v, t_lo[s]));
                        });
#pragma unroll
                for (int s = 0; s < S; ++s)
                    sc[s] = fmcw::classify(fmcw::as_int(hi[s]),
                                           fmcw::as_int(lo[s]), c.k, g);
            }
        }
        // The decision cut > est * sc by counting refs >= q.
        V cut[S], q[S];
        Cnt cnt[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            cut[s] = tile[((size_t)c.ha * E + i0 + s + c.hr) * P + off + d];
            q[s] = Sem::q(cut[s], sc[s]);
            cnt[s] = 0;
        }
        for (int p = 0; p < np; ++p)
            fmcw::walk_window_t<S, HR, GR, !kHalo>(
                tile + ((size_t)p * E + i0) * P + off, P, d, g,
                p >= g_lo && p <= g_hi, [&](int, int s, V v) {
                    cnt[s] = fmcw::count_add(cnt[s], fmcw::is_ge(v, q[s]));
                });
        const size_t out0 = (((size_t)b * c.A + a) * c.R + r0) * DM + c0 + d;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            if (i0 + s < rows_out && (!kChunk || c0 + d < DM)) {
                const size_t o = out0 + (size_t)(i0 + s) * DM;
                det[o] = (fmcw::as_int(cnt[s]) < c.k && cut[s] > V(0))
                             ? cut[s] : V(0);
                scale_out[o] = sc[s];
            }
        }
    }
}

template <typename V, int S, int HR, int GR, bool kPacked, int kD = 0,
          bool kReflect = false, bool kChunk = false>
int launch_variant(const void* cube, void* det, void* scale_out,
                   const Cfar3dConfig& c, cudaStream_t stream) {
    const size_t smem = smem_elems(c) * sizeof(V);
    auto* kernel =
        cfar3d_detect_kernel<V, S, HR, GR, kPacked, kD, kReflect, kChunk>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_chunks = kChunk ? (c.D + c.W - 1) / c.W : 1;
    const dim3 grid((c.R + c.T - 1) / c.T * n_chunks, c.A, c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(cube), static_cast<V*>(det),
        static_cast<int*>(scale_out), c);
    return (int)cudaGetLastError();
}

// The repository's windows with a row pitch known at compile time: every
// shared-memory offset of the unrolled walks is then an immediate.
template <typename V, int HR, int GR>
int launch_window(const void* cube, void* det, void* scale_out,
                  const Cfar3dConfig& c, cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.D == 128)
        return launch_variant<V, S, HR, GR, true, 128>(cube, det, scale_out,
                                                       c, s);
    return launch_variant<V, S, HR, GR, true>(cube, det, scale_out, c, s);
}

// The reflect entry's variants: the same choice, with only the default
// window (6, 2) unrolled at its pitch of 128 + 10 columns (each unrolled
// variant costs build time); the column chunks' (kChunk) likewise, at a
// chunk of 128 columns.
template <typename V, bool kReflect, bool kChunk>
int launch_halo(const void* cube, void* det, void* scale_out,
                const Cfar3dConfig& c, cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.strip == 1)
        return launch_variant<V, 1, 0, 0, false, 0, kReflect, kChunk>(
            cube, det, scale_out, c, s);
    if (!c.packed)
        return launch_variant<V, S, 0, 0, false, 0, kReflect, kChunk>(
            cube, det, scale_out, c, s);
    if (c.hr == 6 && c.gr == 2 && pitch(c) == 138)
        return launch_variant<V, S, 6, 2, true, 138, kReflect, kChunk>(
            cube, det, scale_out, c, s);
    return launch_variant<V, S, 0, 0, true, 0, kReflect, kChunk>(
        cube, det, scale_out, c, s);
}

// The strip length, the count's packing, the window and the row pitch pick
// the variant; only packed strips of 8 unroll the repository's windows.
template <typename V>
int launch(const void* cube, void* det, void* scale_out,
           const Cfar3dConfig& c, cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.W < c.D)
        return launch_halo<V, false, true>(cube, det, scale_out, c, s);
    if (c.reflect)
        return launch_halo<V, true, false>(cube, det, scale_out, c, s);
    if (c.strip == 1)
        return launch_variant<V, 1, 0, 0, false>(cube, det, scale_out, c, s);
    if (!c.packed)
        return launch_variant<V, S, 0, 0, false>(cube, det, scale_out, c, s);
    if (c.hr == 6 && c.gr == 2)
        return launch_window<V, 6, 2>(cube, det, scale_out, c, s);
    if (c.hr == 3 && c.gr == 1)
        return launch_window<V, 3, 1>(cube, det, scale_out, c, s);
    return launch_variant<V, S, 0, 0, true>(cube, det, scale_out, c, s);
}

}  // namespace

// cube/det: int32 (integer != 0) or float32 (batch, A, R, D) — the cube
// (batch, A + 2 ha, R, D) with prepadded; scale_out: int32 (batch, A, R,
// D).  strip: 8 (fmcw::kStrip, T >= 8) or 1; packed: hi and lo in one count
// (n_ref <= 4094 for float, 32767 for int32 cubes); reflect: numpy's mirror
// in place of the wrap on every axis (the beam axis not, prepadded; a
// single mirror: ha < A unless prepadded, hr < R, hd < D); W: D (whole
// rows) or a chunk of fewer columns.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fmcw_cfar_3d_detect(const void* cube, void* det,
                                   void* scale_out, const Cfar3dConfig* cfg,
                                   void* stream) {
    const Cfar3dConfig c = *cfg;
    const int max_packed =
        c.integer ? kMaxPackedInt : fmcw::kMaxPackedRef<float>;
    if (c.batch < 1 || c.batch > 65535 || c.A < 1 || c.A > 65535 ||
        c.R < 1 || c.D < 1 || c.T < 1 || c.W < 1 || c.W > c.D ||
        c.hd >= c.D || c.hr < c.gr ||
        c.hd < c.gd || c.ha < 1 || c.ga < 0 || c.ga >= c.ha || c.so < 0 ||
        !(c.strip == 1 || (c.strip == fmcw::kStrip && c.T >= c.strip)) ||
        (c.packed && (c.strip == 1 || c.n_ref > max_packed)) ||
        (c.reflect != 0 && c.reflect != 1) ||
        (c.reflect && (c.hr >= c.R || (!c.prepadded && c.ha >= c.A))) ||
        smem_elems(c) * 4 > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch<int>(cube, det, scale_out, c, s)
                     : launch<float>(cube, det, scale_out, c, s);
}
