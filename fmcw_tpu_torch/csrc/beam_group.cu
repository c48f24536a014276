// Cross-beam peak grouping with the top-K extraction's epilogues, on Hopper.
//
// Replaces fmcw_tpu/ops/cfar_pallas.py::_kernel_beam_group (called through
// peak_group_beams_pallas): keep det[b, r, d] only if it is the maximum over
// beams b - radius .. b + radius at the same (r, d) cell, ties toward the
// lower beam (m >= the beam above, m > the beam below); the beam axis does
// not wrap, and a missing neighbour beyond an edge counts as 0 (it never
// beats a detection).  The semantics of ops/cfar.peak_group_beams.  Besides
// the grouped cube it writes each row's maximum and the number of kept
// detections per cube, which ops/detect.topk_detections takes so that it
// never re-reads the grouped cube.
//
// In:  det float32 (B, NB, R, D) — or, with halo = radius > 0, (B, NB + 2
//      halo, R, D): a beam shard with its neighbours' planes on each side
//      (the sharded array model, fmcw_tpu/parallel/sharded.py:604-616),
//      plane i being global beam (id0 + i) mod n_total.  A neighbour at
//      offset o counts only if no global beam edge lies between it and the
//      cell's plane (gid + o < n_total above, gid - o >= 0 below), so the
//      global beam edges stay edges; the whole cube is halo 0, id0 0,
//      n_total NB, where that test is the plane's own bounds.
// Out: grouped det (B, NB, R, D) — a shard's interior planes —, row_max
//      float32 (B, NB * R), n_dets int32 (B,) (integer sums, exact).
//
// Bound on an H100: bytes — each input plane read once, the grouped planes
// written once (8 B a cell of the whole cube; a shard also reads its 2 halo
// planes), the row maxima; 2 radius + 2 compares a cell.
//
// Design: one warp owns one (cube, range row) and walks the beam axis.  Its
// lanes hold 4 adjacent cells each (float4; D = 128 is 32 lanes x 4), so
// every plane's row is loaded once, as 16-byte loads, into a sliding
// register window of 2 radius + 1 planes (radius 0-3 at compile time).
// The load of the plane after next is issued before the current plane's
// decision (two planes in flight: 7% faster on the shard than one, PERF.md
// §6); the middle plane is decided against its window and stored as
// float4, and the row's maximum is reduced with shuffles.  A D that is not
// a multiple of 4 (or an unaligned cube) walks with one cell a lane; a row
// wider than 32 lanes' cells walks once per chunk of columns, the row
// maximum carried across chunks by the same lane.  The global beam id
// advances by one a plane (one test a walk, none a row).  Radii above 3
// read their neighbours from memory (no register window; not on any main
// path).
// The counts: each warp sums its cells, each block its warps; the blocks
// of a cube add theirs with one integer atomic each onto n_dets, which the
// C entry zeroes on the same stream (cudaMemsetAsync), so the wrapper
// launches nothing else.  (Per-block partials summed by the cube's last
// block, behind a ticket, were 1.2-1.5 us slower a launch in graph
// replay: PERF.md §6.)

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors BeamGroupConfig in kernels.py (ctypes.Structure, all int32).
struct BeamGroupConfig {
    int batch, NB, R, D, radius, halo, id0, n_total;
};

namespace {

constexpr int kWarps = 8;           // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWindowRadius = 3;

template <int V>
__device__ __forceinline__ void load_cells(const float* __restrict__ row,
                                           int col, int D, float (&x)[V]) {
    if (col < D) {
        if constexpr (V == 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(row + col));
            x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
        } else {
            x[0] = __ldg(row + col);
        }
    } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
}

template <int V>
__device__ __forceinline__ void store_cells(float* __restrict__ row, int col,
                                            int D, const float (&x)[V]) {
    if (col >= D) return;
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(row + col) =
            make_float4(x[0], x[1], x[2], x[3]);
    } else {
        row[col] = x[0];
    }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, s);
    return v;
}

// The walk's shape, uniform across the warp.
struct Walk {
    const float* src;   // &det[b, 0, r, 0]
    float* dst;         // &out[b, 0, r, 0]
    float* rmax;        // &row_max[b, r] (plane i at + i * R)
    size_t plane;       // R * D
    int R, D, NB, nb_in, q0, gid0, n_total;
};

// The row's max over this chunk into row_max: stored by the first chunk,
// raised by the later ones (the same lane, in order).
__device__ __forceinline__ void put_row_max(float* p, float mx, int c0,
                                            int lane) {
    mx = warp_max(mx);
    if (lane == 0) *p = c0 == 0 ? mx : fmaxf(*p, mx);
}

// Radius RAD (0..3) with the sliding register window w[k] = plane q - RAD
// + k; planes beyond the cube's (or shard's) ends load as 0.
template <int RAD, int V>
__device__ __forceinline__ int walk_window(const Walk& a, int lane) {
    constexpr int W = 2 * RAD + 1;
    int kept = 0;
    for (int c0 = 0; c0 < a.D; c0 += 32 * V) {
        const int col = c0 + lane * V;
        float w[W][V];
#pragma unroll
        for (int k = 0; k < W; ++k) {
            const int j = a.q0 - RAD + k;
            if (j >= 0 && j < a.nb_in) {
                load_cells<V>(a.src + j * a.plane, col, a.D, w[k]);
            } else {
#pragma unroll
                for (int e = 0; e < V; ++e) w[k][e] = 0.f;
            }
        }
        int gid = a.gid0;
        float nxt[V];               // plane q + RAD + 1, loaded a step early
        {
            const int j = a.q0 + RAD + 1;
            if (1 < a.NB && j < a.nb_in) {
                load_cells<V>(a.src + j * a.plane, col, a.D, nxt);
            } else {
#pragma unroll
                for (int e = 0; e < V; ++e) nxt[e] = 0.f;
            }
        }
        for (int i = 0; i < a.NB; ++i) {
            // The plane after next goes out before this plane's decision.
            const int j = a.q0 + i + RAD + 2;
            float nxt2[V];
            if (i + 2 < a.NB && j < a.nb_in) {
                load_cells<V>(a.src + j * a.plane, col, a.D, nxt2);
            } else {
#pragma unroll
                for (int e = 0; e < V; ++e) nxt2[e] = 0.f;
            }
            const int up_lim = a.n_total - 1 - gid;  // offsets above that count
            const int dn_lim = gid;                  // offsets below that count
            float g[V];
            float mx = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const float m = w[RAD][e];
                bool keep = m > 0.f;
#pragma unroll
                for (int o = 1; o <= RAD; ++o) {
                    keep = keep && (o > up_lim || m >= w[RAD + o][e])
                                && (o > dn_lim || m > w[RAD - o][e]);
                }
                g[e] = keep ? m : 0.f;
                kept += keep;
                mx = fmaxf(mx, g[e]);
            }
            store_cells<V>(a.dst + i * a.plane, col, a.D, g);
            put_row_max(a.rmax + (size_t)i * a.R, mx, c0, lane);
#pragma unroll
            for (int k = 0; k + 1 < W; ++k) {
#pragma unroll
                for (int e = 0; e < V; ++e) w[k][e] = w[k + 1][e];
            }
#pragma unroll
            for (int e = 0; e < V; ++e) {
                w[W - 1][e] = nxt[e];
                nxt[e] = nxt2[e];
            }
            gid = gid + 1 == a.n_total ? 0 : gid + 1;
        }
    }
    return kept;
}

// Any radius: the neighbours read from memory, one plane pair an offset.
template <int V>
__device__ __forceinline__ int walk_any(const Walk& a, int radius,
                                        int lane) {
    int kept = 0;
    for (int c0 = 0; c0 < a.D; c0 += 32 * V) {
        const int col = c0 + lane * V;
        int gid = a.gid0;
        for (int i = 0; i < a.NB; ++i) {
            const int q = a.q0 + i;
            float m[V];
            bool keep[V];
            load_cells<V>(a.src + q * a.plane, col, a.D, m);
#pragma unroll
            for (int e = 0; e < V; ++e) keep[e] = m[e] > 0.f;
            const int up_lim = min(a.n_total - 1 - gid, a.nb_in - 1 - q);
            const int dn_lim = min(gid, q);
            for (int o = 1; o <= radius; ++o) {
                float x[V];
                if (o <= up_lim) {
                    load_cells<V>(a.src + (q + o) * a.plane, col, a.D, x);
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        keep[e] = keep[e] && m[e] >= x[e];
                }
                if (o <= dn_lim) {
                    load_cells<V>(a.src + (q - o) * a.plane, col, a.D, x);
#pragma unroll
                    for (int e = 0; e < V; ++e)
                        keep[e] = keep[e] && m[e] > x[e];
                }
            }
            float g[V];
            float mx = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                g[e] = keep[e] ? m[e] : 0.f;
                kept += keep[e];
                mx = fmaxf(mx, g[e]);
            }
            store_cells<V>(a.dst + i * a.plane, col, a.D, g);
            put_row_max(a.rmax + (size_t)i * a.R, mx, c0, lane);
            gid = gid + 1 == a.n_total ? 0 : gid + 1;
        }
    }
    return kept;
}

// RAD 0..3: the register window; RAD -1: any radius.  The counts are
// added onto n_dets, zeroed by the C entry.
template <int RAD, int V>
__global__ void __launch_bounds__(kThreads)
beam_group_kernel(const float* __restrict__ det, float* __restrict__ out,
                  float* __restrict__ row_max, int* __restrict__ n_dets,
                  const BeamGroupConfig c) {
    __shared__ int warp_kept[kWarps];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    const int b = blockIdx.y;
    int kept = 0;
    if (row < c.R) {
        Walk a;
        a.nb_in = c.NB + 2 * c.halo;
        a.plane = (size_t)c.R * c.D;
        a.src = det + (size_t)b * a.nb_in * a.plane + (size_t)row * c.D;
        a.dst = out + (size_t)b * c.NB * a.plane + (size_t)row * c.D;
        a.rmax = row_max + (size_t)b * c.NB * c.R + row;
        a.R = c.R;
        a.D = c.D;
        a.NB = c.NB;
        a.q0 = c.halo;
        const int g = (c.id0 + c.halo) % c.n_total;
        a.gid0 = g < 0 ? g + c.n_total : g;
        a.n_total = c.n_total;
        if constexpr (RAD >= 0) kept = walk_window<RAD, V>(a, lane);
        else kept = walk_any<V>(a, c.radius, lane);
    }
    kept = warp_sum(kept);
    if (lane == 0) warp_kept[warp] = kept;
    __syncthreads();
    if (threadIdx.x == 0) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_kept[w];
        if (s) atomicAdd(&n_dets[b], s);
    }
}

template <int V>
cudaError_t launch(int radius, const dim3& grid, cudaStream_t stream,
                   const float* det, float* out, float* row_max, int* n_dets,
                   const BeamGroupConfig& c) {
    switch (radius) {
        case 0: beam_group_kernel<0, V><<<grid, kThreads, 0, stream>>>(
                    det, out, row_max, n_dets, c); break;
        case 1: beam_group_kernel<1, V><<<grid, kThreads, 0, stream>>>(
                    det, out, row_max, n_dets, c); break;
        case 2: beam_group_kernel<2, V><<<grid, kThreads, 0, stream>>>(
                    det, out, row_max, n_dets, c); break;
        case 3: beam_group_kernel<3, V><<<grid, kThreads, 0, stream>>>(
                    det, out, row_max, n_dets, c); break;
        default: beam_group_kernel<-1, V><<<grid, kThreads, 0, stream>>>(
                    det, out, row_max, n_dets, c); break;
    }
    return cudaGetLastError();
}

}  // namespace

// det: float32 (batch, NB + 2 halo, R, D); out: float32 (batch, NB, R, D);
// row_max: float32 (batch, NB * R); n_dets: int32 (batch,), zeroed and
// written here.  Returns the CUDA error code (0 on success).
extern "C" int fmcw_beam_group(const void* det, void* out, void* row_max,
                               void* n_dets, const BeamGroupConfig* cfg,
                               void* stream) {
    const BeamGroupConfig c = *cfg;
    const long long row_blocks = (c.R + (long long)kWarps - 1) / kWarps;
    if (c.batch < 1 || c.batch > 65535 || c.NB < 1 || c.R < 1 || c.D < 1 ||
        row_blocks > 0x7fffffffLL || c.radius < 0 || c.halo < 0 ||
        c.n_total < 1 || (c.halo > 0 && c.radius > 32))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t zeroed =
        cudaMemsetAsync(n_dets, 0, sizeof(int) * (size_t)c.batch, s);
    if (zeroed != cudaSuccess) return (int)zeroed;
    const dim3 grid((unsigned)row_blocks, c.batch);
    const bool vec = c.D % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(det) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int rad = c.radius > kMaxWindowRadius ? -1 : c.radius;
    const float* d = static_cast<const float*>(det);
    float* o = static_cast<float*>(out);
    float* rm = static_cast<float*>(row_max);
    int* nd = static_cast<int*>(n_dets);
    const cudaError_t err = vec ? launch<4>(rad, grid, s, d, o, rm, nd, c)
                                : launch<1>(rad, grid, s, d, o, rm, nd, c);
    return (int)err;
}
