// Standalone 2D OS-CFAR detection by counting, on Hopper, for int32 or
// float32 magnitude maps, with an optional peak-grouping epilogue.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_detect (per-cell scale:
// mean pass, hi/lo pass, threshold pass) and ::_kernel_detect_scaled (the
// threshold pass alone, with a scale map computed outside the kernel — the
// block scale of ops/cfar.block_scale_map), both called through
// cfar_2d_pallas_detect.  One kernel with a flag: block_mode reads the
// scale map.
//
// In:  map (B, R, D) int32 or float32 — or, prepadded, (B, R + 2 hr, D):
//      a range shard with the halo_range rows beyond each edge exchanged
//      from its neighbours on a sequence-parallel mesh (the sharded CFAR of
//      fmcw_tpu/parallel/sharded.py, cfar_2d_pallas_detect(prepadded_range=
//      True)); the range axis then does not wrap.  scale_in int32 (B, R, D)
//      when block_mode (else null).
// Out: det (B, R, D) in the map's type — the CUT where CUT > est * scale,
//      else 0 — and scale_out int32 (B, R, D), scale_override folded in.
//      The grouping entry (pgr >= 0, whole maps only) stores det
//      peak-grouped over a (2 pgr + 1)^2 wrapped neighbourhood
//      (ops/cfar.peak_group, by fmcw::group_store), and row_max (B, R) in
//      the map's type and n_dets (B,) int32 (zeroed by the caller) for
//      ops/detect.topk_detections.
//
// Bound on an H100: operations — per cell and training value, the per-cell
// scale's two hi/lo compare-adds and the decision's one (a scale map: the
// decision's alone), n_ref = 128 at the default window; the bytes are 12
// per cell (16 with a scale map).  A float compare is one FSET (1.0 / 0.0,
// on the integer pipe, half the FP32 lanes) and its count an add on the FMA
// pipe (cfar_tile.cuh), so the integer pipe's 3 ops (1 with a scale map)
// per training value and cell are the floor of this design.
//
// Design (cfar_tile.cuh's plan, as kernel B and the 3D CFAR).  One block of
// 256 threads per (frame, tile of T range rows), three blocks an SM
// (ops/cfar_detect.tile_plan picks T: 32 at the default window, 28 with
// grouping radius 2, 64 with a scale map):
//   1. the T + 2 (hr + pgr) rows the windows and the grouping reach are
//      copied into shared memory whole, one warp a row, 16-byte cp.async
//      copies where D and the map allow (rows wrapped modulo R once a row,
//      or a prepadded shard's rows straight; no division per element).  A
//      last block past R decides wrapped rows and stores none of them.
//   2. Int32 maps whose tile values all lie within float_max (the
//      wrapper's limit: the values, column sums, thresholds and q are then
//      exact in float, and no box sum wraps) are converted to float in
//      place and counted in float with the integer semantics
//      (fmcw::IntInFloat) — the fixed chain's magnitudes (at most 45,056)
//      always are; a tile with any value beyond it counts in int.  The
//      choice is one __syncthreads_and, uniform across the block.
//   3. Per-cell scale: the full (2 hr + 1 rows) and guard (2 gr + 1 rows)
//      column sums of every decided row, rows ascending from -0, into
//      shared memory (a one-row window's column sums are its rows).
//   4. A thread takes a strip of S = 8 cells of one Doppler column (threads
//      of a warp on neighbouring columns; the last strip overlaps its
//      neighbour when 8 does not divide the decided rows).  Per cell the
//      box sums from the column sums in the twin's order (columns
//      ascending; integer sums with the strip's 8 chains side by side),
//      the thresholds, then one walk per window column of its 2 hr + 1
//      rows through a ring of 8 registers (each value loaded once for the
//      8 cells), the guard rows of the guard columns left out: hi and lo in
//      one packed count (float: hi * 4096 + lo, exact while n_ref <= 4094;
//      int: hi * 65536 + lo), else two counts; then the decision walk
//      counting refs >= q (cfar_common.cuh's detect_threshold).  A scale
//      map or a scale override skips the hi/lo walk.  The (6, 2) and (3,
//      1) windows walk unrolled, and with D = 128 the row pitch is a
//      compile-time constant, so every shared-memory offset of a walk is
//      an immediate.
//   5. The grouping entry decides pgr rows beyond each side of the tile
//      into shared memory, then groups and stores the T rows with their
//      row maxima and count (cfar_common.cuh's group_store).
// A tile too large for strips of 8 (8 rows do not fit in shared memory)
// takes S = 1, a cell a thread.  Decisions and scales are bit-identical to
// ops/cfar.cfar_2d on the same map; tests/test_torch_cfar_detect_plan.py
// holds a numpy model of this plan against it.
//
// The flat-stream entry (fmcw_cfar_detect_flat) is _kernel_detect with
// prepadded_range="both" (cfar_pallas.py:365-375), which only the hw-compat
// streaming CFAR reaches (fmcw_tpu/ops/cfar.py::_hw_stream_decide_pallas):
// the as-built detector's decisions on the stream's row-carry-baked padded
// buffer, the CfarParams axes swapped (rows: the range axis under the
// Doppler generics; lanes: the stream's Doppler axis under the range
// generics).  It never materializes that buffer (74 MB at batch 128):
// padded row e of frame b is the run of D + 2 hd stream cells from start0
// + (e - hr) D - hd of the batch of ext streams (stride cells a frame), and
// step 1 copies those overlapping runs straight into the tile, 16 bytes at
// a time where the block's rows align, else 4 (the one-shot framing's rows
// start 2 cells off a 16-byte boundary at the default window).  The tile's
// rows then carry their column halo: pitch D + 2 hd (140 at 1024x128, a
// compile-time constant for the default window), columns read unwrapped
// (cfar_tile.cuh's walks with kWrap false), column sums taken over every
// column of the decided rows.  Steps 2-4 are the whole-map entry's, so the
// decisions are bit-identical to ops/cfar.hw_stream_decide_plain (the
// twin's cfar_2d(prepadded_range="both")).  No block scale, no grouping:
// the emission window, label roll and peak grouping stay outside, as they
// are outside JAX's kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cfar_common.cuh"
#include "cfar_tile.cuh"

// Mirrors CfarDetectConfig in kernels.py (ctypes.Structure, all int32).
struct CfarDetectConfig {
    int batch, R, D, T;
    int hr, hd, gr, gd, n_ref, k;
    int scale_min, scale_nom, scale_max;
    int block_mode, so, integer, prepadded;
    int strip, packed;
    int pgr;            // grouping radius; -1: no grouping (det as decided)
    int float_max;      // int32 tiles within +-float_max count in float
    // The flat-stream entry (flat = 1): the map is a batch of ext streams,
    // frame b's at map + b * stride; padded row e of the tile is the
    // stream cells [start0 + (e - hr) D - hd, ... + D + 2 hd).
    int flat, start0, stride;
};

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 3;

// Shared memory layout, in 4-byte words (the C entry checks its total;
// ops/cfar_detect.tile_bytes mirrors it).
struct Layout {
    int cs_full, cs_guard, det_s, rmax, counts, total;
};

// The tile's row pitch: D, or D + 2 hd for the flat-stream entry, whose
// rows carry their column halo.
__host__ __device__ inline int pitch(const CfarDetectConfig& c) {
    return c.flat ? c.D + 2 * c.hd : c.D;
}

__host__ __device__ inline Layout layout(const CfarDetectConfig& c) {
    const int pg = c.pgr > 0 ? c.pgr : 0;
    const int rows = c.T + 2 * pg;              // decided rows
    const int P = pitch(c);
    const int cs = (!c.block_mode && c.hr > 0) ? rows * P : 0;
    const bool group = c.pgr >= 0;
    Layout l;
    l.cs_full = (c.T + 2 * (c.hr + pg)) * P;    // after the tile
    l.cs_guard = l.cs_full + cs;
    l.det_s = l.cs_guard + cs;
    l.rmax = l.det_s + (group ? rows * c.D : 0);
    l.counts = l.rmax + (group ? c.T : 0);
    l.total = l.counts + (group ? 2 : 0);
    return l;
}

__device__ __forceinline__ float to_map(float v, float*) { return v; }
__device__ __forceinline__ int to_map(int v, int*) { return v; }
__device__ __forceinline__ int to_map(float v, int*) {
    return __float2int_rn(v);
}

// Steps 3-5 on a tile of type V (the map's, or float for an int32 tile
// counted in float) with thresholds by Sem, storing in the map's type O.
// kD: the tile's row pitch at compile time (0: at run time); kFlat: the
// flat-stream entry (rows of D + 2 hd cells, columns unwrapped).
template <typename V, typename Sem, typename O, int S, int HR, int GR,
          bool kPacked, int kD, bool kFlat>
__device__ __forceinline__ void decide_block(
        const V* tile, int* smem, const int* __restrict__ scale_in,
        O* __restrict__ det, int* __restrict__ scale_out,
        O* __restrict__ row_max, int* __restrict__ n_dets,
        const CfarDetectConfig& c) {
    using A = typename Sem::Acc;
    using Cnt = fmcw::Count<V>;
    const Layout lay = layout(c);
    const int P = kD > 0 ? kD : pitch(c);       // the tile's row pitch
    const int D = kFlat ? c.D : P;              // the columns decided
    const int off = kFlat ? c.hd : 0;           // tile column of column 0
    // Tile column of window column d + j: unwrapped where the rows carry
    // their halo, else modulo D.
    auto wcol = [&](int d, int j) {
        return kFlat ? off + d + j : fmcw::wrap_col(d + j, D);
    };
    const int hr = HR > 0 ? HR : c.hr;
    const int gr = HR > 0 ? GR : c.gr;
    const bool group = c.pgr >= 0;
    const int pg = group ? c.pgr : 0;
    const int rows = c.T + 2 * pg;              // map rows r0 - pg ..
    const int r0 = blockIdx.x * c.T;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int rows_out = min(c.T, c.R - r0);    // rows stored
    const int units = (rows + S - 1) / S * D;   // strips x columns

    // 3. Column sums of the decided rows (decided row i: tile row hr + i;
    //    its window's first row: tile row i), over every column of the
    //    tile's rows.
    const V* cs_full = tile + hr * P;
    const V* cs_guard = cs_full;
    if (!c.block_mode && c.so == 0 && hr > 0) {
        V* f_s = reinterpret_cast<V*>(smem + lay.cs_full);
        V* g_s = reinterpret_cast<V*>(smem + lay.cs_guard);
        const int cs_units = (rows + S - 1) / S * P;
        for (int u = tid; u < cs_units; u += kThreads) {
            const int st = u / P;
            const int d = u - st * P;
            const int i0 = min(st * S, rows - S);
            V f[S], gs[S];
#pragma unroll
            for (int s = 0; s < S; ++s) f[s] = gs[s] = fmcw::sum_identity<V>();
            auto add = [&](int dr, int s, V v) {
                f[s] = fmcw::vadd(f[s], v);
                if (dr >= hr - gr && dr <= hr + gr)
                    gs[s] = fmcw::vadd(gs[s], v);
            };
            const V* col = tile + i0 * P + d;
            if constexpr (HR > 0)
                fmcw::walk_rows_fixed<S, HR, GR, false>(col, P, add);
            else
                fmcw::walk_rows<S>(col, P, 2 * hr + 1,
                                   [](int) { return true; }, add);
#pragma unroll
            for (int s = 0; s < S; ++s) {
                f_s[(i0 + s) * P + d] = f[s];
                g_s[(i0 + s) * P + d] = gs[s];
            }
        }
        cs_full = f_s;
        cs_guard = g_s;
        __syncthreads();
    }

    // 4. The strips' decisions.
    const fmcw::CfarGeom g{hr, c.hd, gr, c.gd, c.n_ref, c.k,
                           c.scale_min, c.scale_nom, c.scale_max};
    O* det_s = reinterpret_cast<O*>(smem + lay.det_s);
    for (int u = tid; u < units; u += kThreads) {
        const int st = u / D;
        const int d = u - st * D;
        const int i0 = min(st * S, rows - S);
        const V* row0 = tile + i0 * P + off;    // cell 0's window, column 0
        int sc[S];
        if (c.so != 0) {
#pragma unroll
            for (int s = 0; s < S; ++s) sc[s] = c.so;
        } else if (c.block_mode) {
#pragma unroll
            for (int s = 0; s < S; ++s)
                sc[s] = scale_in[((size_t)b * c.R +
                                  fmcw::wrap_mod(r0 - pg + i0 + s, c.R)) * D +
                                 d];
        } else {
            // Box sums in the twin's order (columns ascending), then the
            // thresholds and the hi/lo counts.  Integer sums (int32 maps,
            // in int or held in float) run the strip's 8 chains side by
            // side, float sums one cell's chain after another: each order
            // was the faster in its A/B (PERF.md, Findings).
            A full[S], guard[S];
#pragma unroll
            for (int s = 0; s < S; ++s)
                full[s] = guard[s] = fmcw::sum_identity<A>();
            if constexpr (std::is_same_v<A, float>) {
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    const V* cf = cs_full + (i0 + s) * P;
                    const V* cg = cs_guard + (i0 + s) * P;
                    for (int j = -c.hd; j <= c.hd; ++j)
                        full[s] = fmcw::vadd(full[s], cf[wcol(d, j)]);
                    for (int j = -c.gd; j <= c.gd; ++j)
                        guard[s] = fmcw::vadd(guard[s], cg[wcol(d, j)]);
                }
            } else {
                for (int j = -c.hd; j <= c.hd; ++j) {
                    const V* cf = cs_full + i0 * P + wcol(d, j);
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        full[s] = fmcw::vadd(full[s], Sem::acc(cf[s * P]));
                }
                for (int j = -c.gd; j <= c.gd; ++j) {
                    const V* cg = cs_guard + i0 * P + wcol(d, j);
#pragma unroll
                    for (int s = 0; s < S; ++s)
                        guard[s] = fmcw::vadd(guard[s], Sem::acc(cg[s * P]));
                }
            }
            V t_hi[S], t_lo[S];
#pragma unroll
            for (int s = 0; s < S; ++s)
                Sem::thresholds(fmcw::vsub(full[s], guard[s]), c.n_ref,
                                t_hi[s], t_lo[s]);
            if constexpr (kPacked) {
                Cnt hl[S];
#pragma unroll
                for (int s = 0; s < S; ++s) hl[s] = 0;
                fmcw::walk_window_t<S, HR, GR, !kFlat>(
                    row0, P, d, g, true, [&](int, int s, V v) {
                        hl[s] = fmcw::count_hi_lo(hl[s], v, t_hi[s], t_lo[s]);
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
                fmcw::walk_window_t<S, HR, GR, !kFlat>(
                    row0, P, d, g, true, [&](int, int s, V v) {
                        hi[s] = fmcw::count_add(hi[s],
                                                fmcw::is_gt(v, t_hi[s]));
                        lo[s] = fmcw::count_add(lo[s],
                                                fmcw::is_ge(v, t_lo[s]));
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
            cut[s] = tile[(hr + i0 + s) * P + off + d];
            q[s] = Sem::q(cut[s], sc[s]);
            cnt[s] = 0;
        }
        fmcw::walk_window_t<S, HR, GR, !kFlat>(
            row0, P, d, g, true, [&](int, int s, V v) {
                cnt[s] = fmcw::count_add(cnt[s], fmcw::is_ge(v, q[s]));
            });
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const O out = (fmcw::as_int(cnt[s]) < c.k && cut[s] > V(0))
                              ? to_map(cut[s], (O*)nullptr) : O(0);
            if (group) det_s[(i0 + s) * D + d] = out;
            const int t = i0 + s - pg;          // the tile's own row
            if (t >= 0 && t < rows_out) {
                const size_t o = ((size_t)b * c.R + r0 + t) * D + d;
                scale_out[o] = sc[s];
                if (!group) det[o] = out;
            }
        }
    }
    if (kFlat || !group) return;
    __syncthreads();

    // 5. Peak grouping of the stored rows, row maxima and the count (the
    //    tile is only read for its non-finite count, which is not kept).
    int* rmax_s = smem + lay.rmax;
    int* counts = smem + lay.counts;
    fmcw::group_store(det_s, reinterpret_cast<const O*>(tile), rows_out,
                      hr + pg, pg, c.R, D, r0, ((size_t)b * c.R + r0) * D,
                      det, (O*)nullptr, rmax_s, counts);
    __syncthreads();
    for (int t = tid; t < rows_out; t += kThreads)
        fmcw::from_ordered(rmax_s[t], row_max + (size_t)b * c.R + r0 + t);
    if (tid == 0 && counts[0]) atomicAdd(&n_dets[b], counts[0]);
}

template <typename V, int S, int HR, int GR, bool kPacked, int kD,
          bool kFlat>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
cfar_detect_kernel(const V* __restrict__ map, const int* __restrict__ scale_in,
                   V* __restrict__ det, int* __restrict__ scale_out,
                   V* __restrict__ row_max, int* __restrict__ n_dets,
                   const CfarDetectConfig c) {
    extern __shared__ int4 smem_v4[];
    int* smem = reinterpret_cast<int*>(smem_v4);
    V* tile = reinterpret_cast<V*>(smem);
    const int D = kD > 0 ? kD : pitch(c);       // the tile's row pitch
    const int pg = c.pgr > 0 ? c.pgr : 0;
    const int H = c.hr + pg;                    // tile row of map row r0
    const int E = c.T + 2 * H;
    const int r0 = blockIdx.x * c.T;
    const int tid = threadIdx.x;

    // 1. Map rows r0 - H .. r0 + T + H - 1, a warp a row.
    if constexpr (kFlat) {
        // Padded row r0 + e of frame b: D + 2 hd stream cells from
        // start0 + (r0 + e - hr) c.D - hd.  Rows past the last padded row
        // (R + 2 hr) are only read by decided rows past R: zeros.
        const V* src0 = map + (size_t)blockIdx.y * c.stride +
                        (c.start0 - c.hr * c.D - c.hd);
        const int rows_in = c.R + 2 * c.hr;
        const bool vec = (c.D & 3) == 0 && (D & 3) == 0 &&
                         ((uintptr_t)src0 & 15) == 0;
        const int lane = tid & 31;
        for (int e = tid >> 5; e < E; e += kThreads / 32) {
            V* dst = tile + (size_t)e * D;
            const V* src = src0 + (size_t)(r0 + e) * c.D;
            if (r0 + e >= rows_in) {
                for (int i = lane; i < D; i += 32) dst[i] = V(0);
            } else if (vec) {
                for (int i = 4 * lane; i < D; i += 128)
                    fmcw::cp_async16(dst + i, src + i);
            } else {
                for (int i = lane; i < D; i += 32)
                    fmcw::cp_async4(dst + i, src + i);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
        const int rows_in = c.prepadded ? c.R + 2 * c.hr : c.R;
        const V* src0 = map + (size_t)blockIdx.y * rows_in * D;
        const bool vec = (D & 3) == 0 && ((uintptr_t)map & 15) == 0;
        const int lane = tid & 31;
        for (int e = tid >> 5; e < E; e += kThreads / 32) {
            // A prepadded shard's row r0 + e is the map's row r0 - hr + e.
            const int row = c.prepadded ? fmcw::wrap_mod(r0 + e, rows_in)
                                        : fmcw::wrap_mod(r0 - H + e, c.R);
            const V* src = src0 + (size_t)row * D;
            V* dst = tile + (size_t)e * D;
            if (vec) {
                for (int i = 4 * lane; i < D; i += 128)
                    fmcw::cp_async16(dst + i, src + i);
            } else {
                for (int i = lane; i < D; i += 32)
                    fmcw::cp_async4(dst + i, src + i);
            }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    }
    if (c.pgr >= 0) {
        const Layout lay = layout(c);
        for (int i = tid; i < c.T; i += kThreads) smem[lay.rmax + i] = 0;
        if (tid < 2) smem[lay.counts + tid] = 0;
    }
    __syncthreads();

    // 2. An int32 tile within +-float_max counts in float.
    if constexpr (std::is_same_v<V, int> && S > 1 && kPacked) {
        bool mine = true;
        for (int i = tid; i < E * D; i += kThreads) {
            const int v = tile[i];
            const unsigned a = v < 0 ? 0u - (unsigned)v : (unsigned)v;
            mine &= a <= (unsigned)c.float_max;
        }
        if (__syncthreads_and(mine)) {
            float* ft = reinterpret_cast<float*>(smem);
            for (int i = tid; i < E * D; i += kThreads)
                ft[i] = __int2float_rn(tile[i]);
            __syncthreads();
            decide_block<float, fmcw::IntInFloat, V, S, HR, GR, kPacked, kD,
                         kFlat>(ft, smem, scale_in, det, scale_out, row_max,
                                n_dets, c);
            return;
        }
    }
    decide_block<V, fmcw::MapSem<V>, V, S, HR, GR, kPacked, kD, kFlat>(
        tile, smem, scale_in, det, scale_out, row_max, n_dets, c);
}

template <typename V, int S, int HR, int GR, bool kPacked, int kD = 0,
          bool kFlat = false>
int launch_variant(const void* map, const void* scale_in, void* det,
                   void* scale_out, void* row_max, void* n_dets,
                   const CfarDetectConfig& c, cudaStream_t stream) {
    const size_t smem = (size_t)layout(c).total * 4;
    auto* kernel = cfar_detect_kernel<V, S, HR, GR, kPacked, kD, kFlat>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((c.R + c.T - 1) / c.T, c.batch);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const V*>(map), static_cast<const int*>(scale_in),
        static_cast<V*>(det), static_cast<int*>(scale_out),
        static_cast<V*>(row_max), static_cast<int*>(n_dets), c);
    return (int)cudaGetLastError();
}

// The repository's windows with a row pitch known at compile time: every
// shared-memory offset of the unrolled walks is then an immediate.
template <typename V, int HR, int GR>
int launch_window(const void* map, const void* scale_in, void* det,
                  void* scale_out, void* row_max, void* n_dets,
                  const CfarDetectConfig& c, cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.D == 128)
        return launch_variant<V, S, HR, GR, true, 128>(
            map, scale_in, det, scale_out, row_max, n_dets, c, s);
    return launch_variant<V, S, HR, GR, true>(map, scale_in, det, scale_out,
                                              row_max, n_dets, c, s);
}

// The strip length, the count's packing, the window and the row pitch pick
// the variant; only packed strips of 8 unroll the repository's windows.
template <typename V>
int launch(const void* map, const void* scale_in, void* det, void* scale_out,
           void* row_max, void* n_dets, const CfarDetectConfig& c,
           cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.strip == 1)
        return launch_variant<V, 1, 0, 0, false>(map, scale_in, det,
                                                 scale_out, row_max, n_dets,
                                                 c, s);
    if (!c.packed)
        return launch_variant<V, S, 0, 0, false>(map, scale_in, det,
                                                 scale_out, row_max, n_dets,
                                                 c, s);
    if (c.hr == 6 && c.gr == 2)
        return launch_window<V, 6, 2>(map, scale_in, det, scale_out, row_max,
                                      n_dets, c, s);
    if (c.hr == 3 && c.gr == 1)
        return launch_window<V, 3, 1>(map, scale_in, det, scale_out, row_max,
                                      n_dets, c, s);
    return launch_variant<V, S, 0, 0, true>(map, scale_in, det, scale_out,
                                            row_max, n_dets, c, s);
}

// The flat-stream entry's variants: the same choice, with only the
// default hw-compat window (crossed: 5 rows, guard 1, 6 lanes) unrolled,
// its pitch of 128 + 12 columns at compile time; every other window walks
// its rows at run time (each unrolled variant costs build time).
template <typename V>
int launch_flat(const void* ext, void* det, void* scale_out,
                const CfarDetectConfig& c, cudaStream_t s) {
    constexpr int S = fmcw::kStrip;
    if (c.strip == 1)
        return launch_variant<V, 1, 0, 0, false, 0, true>(
            ext, nullptr, det, scale_out, nullptr, nullptr, c, s);
    if (!c.packed)
        return launch_variant<V, S, 0, 0, false, 0, true>(
            ext, nullptr, det, scale_out, nullptr, nullptr, c, s);
    if (c.hr == 5 && c.gr == 1 && pitch(c) == 140)
        return launch_variant<V, S, 5, 1, true, 140, true>(
            ext, nullptr, det, scale_out, nullptr, nullptr, c, s);
    return launch_variant<V, S, 0, 0, true, 0, true>(
        ext, nullptr, det, scale_out, nullptr, nullptr, c, s);
}

// The checks both kinds of entry share.
bool config_ok(const CfarDetectConfig& c) {
    return c.batch >= 1 && c.batch <= 65535 && c.R >= 1 && c.D >= 1 &&
           c.T >= 1 && c.hr >= c.gr && c.hd >= c.gd && c.gr >= 0 &&
           c.gd >= 0 && c.so >= 0 && c.k >= 1 && c.k <= c.n_ref &&
           c.float_max >= 0 && c.float_max < (1 << 23) &&
           (c.strip == 1 || (c.strip == fmcw::kStrip && c.T >= c.strip)) &&
           !(c.packed && (c.strip == 1 ||
                          c.n_ref > fmcw::kMaxPackedRef<float>)) &&
           (size_t)layout(c).total * 4 <= 227 * 1024;
}

int run_flat(const void* ext, void* det, void* scale_out,
             const CfarDetectConfig& c, void* stream) {
    // Every padded row lies inside its frame's ext stream.
    const long lo = (long)c.start0 - (long)c.hr * c.D - c.hd;
    const long hi = (long)c.start0 + (long)(c.R + c.hr) * c.D + c.hd;
    if (!config_ok(c) || c.flat != 1 || c.block_mode || c.prepadded ||
        c.pgr != -1 || lo < 0 || hi > c.stride)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch_flat<int>(ext, det, scale_out, c, s)
                     : launch_flat<float>(ext, det, scale_out, c, s);
}

int run(const void* map, const void* scale_in, void* det, void* scale_out,
        void* row_max, void* n_dets, const CfarDetectConfig& c,
        void* stream) {
    const bool group = c.pgr >= 0;
    if (!config_ok(c) || c.flat != 0 || c.hd >= c.D || c.pgr < -1 ||
        (group && (c.prepadded || row_max == nullptr ||
                   n_dets == nullptr)) ||
        (c.block_mode && scale_in == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return c.integer ? launch<int>(map, scale_in, det, scale_out, row_max,
                                   n_dets, c, s)
                     : launch<float>(map, scale_in, det, scale_out, row_max,
                                     n_dets, c, s);
}

}  // namespace

// map: int32 (integer != 0) or float32 (batch, R, D), or (batch, R + 2 hr,
// D) with prepadded; det: the map's type (batch, R, D); scale_in: int32
// (batch, R, D) with block_mode, else null; scale_out: int32 (batch, R,
// D).  strip: 8 (fmcw::kStrip, T >= 8) or 1; packed: hi and lo in one count
// (n_ref <= 4094); pgr -1.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int fmcw_cfar_detect(const void* map, const void* scale_in,
                                void* det, void* scale_out,
                                const CfarDetectConfig* cfg, void* stream) {
    if (cfg->pgr != -1) return (int)cudaErrorInvalidValue;
    return run(map, scale_in, det, scale_out, nullptr, nullptr, *cfg, stream);
}

// The grouping entry: as fmcw_cfar_detect on a whole map (not prepadded)
// with pgr >= 0; row_max: the map's type (batch, R); n_dets: int32
// (batch,), zeroed by the caller.
extern "C" int fmcw_cfar_detect_group(const void* map, const void* scale_in,
                                      void* det, void* scale_out,
                                      void* row_max, void* n_dets,
                                      const CfarDetectConfig* cfg,
                                      void* stream) {
    if (cfg->pgr < 0) return (int)cudaErrorInvalidValue;
    return run(map, scale_in, det, scale_out, row_max, n_dets, *cfg, stream);
}

// The flat-stream entry (the hw-compat streaming CFAR, flat = 1): ext
// int32 (integer != 0) or float32, batch streams of stride cells, frame b's
// at ext + b * stride; decides the R x D stream cells from start0 (decision
// order) with the crossed window as named-axis hr/hd/gr/gd (rows: the
// range axis; lanes: the stream's Doppler axis), no wrap on either axis:
// every window reads its halo from the stream, row carry included.  det:
// the stream's type (batch, R, D); scale_out: int32 (batch, R, D).  No
// block scale, no grouping, not prepadded.
extern "C" int fmcw_cfar_detect_flat(const void* ext, void* det,
                                     void* scale_out,
                                     const CfarDetectConfig* cfg,
                                     void* stream) {
    return run_flat(ext, det, scale_out, *cfg, stream);
}
